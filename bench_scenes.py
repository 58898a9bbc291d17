"""Per-scene benchmarks at the BASELINE.json judging configs.

  TwoSpheres:  400x225,  64 spp, max depth 8
  LightTest:   512x512, 256 spp
  CornellBox:  512x512, 1024 spp
  ModelTest:   512x512, 256 spp (OBJ mesh)
  SphereField: 1280x720, 512 spp, BVH rebuild per frame

Prints one JSON line per scene: wall-clock for the full-quality frame
(ended by block_until_ready) and achieved rays/s, with the device and
the card's name and power limit.  Use --quick to divide spp by 16 for
smoke runs.  Runs on a GPU only: without one it exits non-zero.
"""

import argparse
import json
import os
import sys
import tempfile
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="spp / 16")
    ap.add_argument("--scene", action="append", help="subset of scenes")
    ap.add_argument("--regen", action="store_true",
                    help="use the regeneration wavefront renderer")
    ap.add_argument("--reps", type=int, default=1,
                    help="timed frame repetitions; >1 reports the "
                         "median + spread (host-load defense, like "
                         "bench.py)")
    ap.add_argument("--note", default=None,
                    help="free-form tag recorded in each JSON line "
                         "(e.g. 'round3-control' for same-day A/Bs)")
    args = ap.parse_args()

    from rust_pathtracer_tpu.utils import compcache
    from rust_pathtracer_tpu.utils.device import card_power, require_gpu

    device = require_gpu()
    compcache.enable()
    card = card_power()

    import jax

    from rust_pathtracer_tpu.models import get_scene
    from rust_pathtracer_tpu.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu.scene.obj_loader import write_benchmark_obj
    from rust_pathtracer_tpu.wavefront import render_radiance_regen

    objp = os.path.join(tempfile.mkdtemp(), "model.obj")
    write_benchmark_obj(objp)  # ~10k triangles, realistic ModelTest scale

    # (name, kwargs, width, height, spp, bounces, rebuild_bvh, rr, mode)
    # rr = Russian-roulette start bounce (unbiased).  mode: "regen"
    # routes through the regeneration wavefront (estimator-identical;
    # wavefront.py); "cascade:<schedule>" uses the one-jit static
    # cascade (render.py _render_chunk_cascaded_static; estimator-exact,
    # occupancy[-1] asserted zero below).  The renderer choices per
    # scene were set on a 16 GB TPU; not yet measured on the card.
    configs = [
        ("TwoSphereCheckers", {}, 400, 225, 64, 8, False, None, "chunked"),
        ("LightTest", {}, 512, 512, 256, 50, False, None, "regen"),
        ("CornellBox", {}, 512, 512, 1024, 20, False, None, "chunked"),
        # TriangleTest guards the triangle intersection path (Cornell
        # walls + 2 explicit triangles, scene.rs:467-595) at its
        # reference config — previously only correctness-tested, so a
        # triangle-path perf regression was invisible (round-3 review)
        ("TriangleTest", {}, 400, 400, 1000, 20, False, None, "chunked"),
        ("ModelTest", {"obj_path": objp}, 512, 512, 256, 20, False, 4,
         "cascade:auto"),
        ("SphereField", {}, 1280, 720, 512, 20, True, 4,
         "cascade:auto"),
    ]
    # Schedules are AUTO-derived (render.derive_cascade_schedule
    # probe); the renderer's overflow guard re-derives and re-renders
    # if a derived schedule ever drops a live lane, so the assert below
    # can only fire on a logic bug, not occupancy drift.
    key = jax.random.PRNGKey(0)

    for name, kwargs, w, h, spp, bounces, rebuild, rr, mode in configs:
        if args.scene and name not in args.scene:
            continue
        sd = get_scene(name, **kwargs)
        if args.quick:
            spp = max(1, spp // 16)
        cascade_schedule = None
        if mode.startswith("cascade:"):
            cascade_schedule = mode.split(":", 1)[1]
        settings = RenderSettings(
            w, h, spp, bounces, sd.output.image.background,
            russian_roulette_start=rr,
            cascade=cascade_schedule is not None,
            cascade_schedule=cascade_schedule,
        )
        scene = sd.build()
        cam = sd.camera_at(0.0)
        use_regen = args.regen or mode == "regen"
        if use_regen:
            render = lambda *a, **k: render_radiance_regen(  # noqa: E731
                *a, flush_every=2, **k
            )
        else:
            render = render_radiance

        # compile warmup with the same chunk shape as the full run
        chunk = settings.resolve_chunk()
        warm = RenderSettings(
            w, h, chunk, bounces, sd.output.image.background, spp_chunk=chunk,
            russian_roulette_start=rr,
            cascade=cascade_schedule is not None,
            cascade_schedule=cascade_schedule,
        )
        # the regen wavefront bakes spp into its spawn jit (static
        # np.uint32 constant) — a chunk-spp warm would leave the timed
        # run paying a fresh ~20 s compile, so warm with the full
        # settings there
        img, _ = render(scene, cam, settings if use_regen else warm, key)
        img.block_until_ready()

        times = []
        for _rep in range(max(1, args.reps)):
            t0 = time.perf_counter()
            if rebuild:
                scene = sd.build()  # per-frame BVH/scene rebuild, timed
            img, stats = render(scene, cam, settings, key)
            img.block_until_ready()
            times.append(time.perf_counter() - t0)
        times.sort()
        dt = times[len(times) // 2]
        spread = (times[-1] - times[0]) / dt if len(times) > 1 else 0.0
        rays = float(stats.segments)
        if cascade_schedule is not None:
            # unbiasedness guard: no live lane fell past a static slice
            assert float(stats.occupancy[-1]) == 0.0, (
                name, float(stats.occupancy[-1]))
        row = {
            "metric": f"{name} {w}x{h}@{spp}spp frame",
            "value": dt,
            "unit": "s",
            "vs_baseline": rays / dt / 8.0e6,  # rays/s over ref estimate
            "reps": len(times),
            "spread": round(spread, 4),
            "host_load1": round(os.getloadavg()[0], 2),
            "card": card,
            "device": device,
        }
        if args.note:
            row["note"] = args.note
        print(json.dumps(row), flush=True)
        print(
            f"# {name}: {rays:.3g} segments, {rays/dt/1e6:.1f} Mrays/s, "
            f"reps={times} load1={row['host_load1']}",
            file=sys.stderr,
            flush=True,
        )


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # noqa: BLE001 — report, then fail loudly
        print(f"bench_scenes.py: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)

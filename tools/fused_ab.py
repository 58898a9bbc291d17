"""On-card A/B of the fused bounce vs the composed path, in turns.

    python tools/fused_ab.py [--out chiprun_out/fused_ab.json] [--trace DIR]

On the CornellBox bench wavefront (512^2 x 4 spp = 1M lanes) it times:

* the search alone: the unrolled static sweep vs the masked (R, P)
  sweep of ops/intersect.py;
* end to end, the nondiff forward (20 bounces) and the headline
  fwd+bwd step (bench.py) through (a) the composed jnp path (the scene
  routed off the fused bounce) and (b) the fused bounce — each
  compiled once, then timed in turns, forward and reverse order.

``--trace DIR`` adds a profiler trace of 2 fused headline steps and a
per-op device-time summary.  Every time ends in
``block_until_ready``; the card's name and power limit go beside
every number.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _median_ms(fn, args, reps=3, batches=5):
    import jax

    jax.block_until_ready(fn(*args))
    out = []
    for _ in range(batches):
        t0 = time.perf_counter()
        r = None
        for _ in range(reps):
            r = fn(*args)
        jax.block_until_ready(r)
        out.append((time.perf_counter() - t0) / reps * 1e3)
    out.sort()
    return out[len(out) // 2], out


def summarize_trace(trace_dir, top=12):
    """Print each GPU line's busiest event names (summed device time)
    and the device busy share of the traced window."""
    import glob

    import jax

    paths = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    if not paths:
        print(f"# no trace under {trace_dir}")
        return {}
    pd = jax.profiler.ProfileData.from_file(paths[0])
    out = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            if not evs:
                continue
            tot = {}
            for ev in evs:
                tot[ev.name] = tot.get(ev.name, 0.0) + ev.duration_ns
            spans = sorted((ev.start_ns, ev.start_ns + ev.duration_ns)
                           for ev in evs)
            busy, cur_s, cur_e = 0.0, None, None
            for s0, e0 in spans:
                if cur_e is None or s0 > cur_e:
                    if cur_e is not None:
                        busy += cur_e - cur_s
                    cur_s, cur_e = s0, e0
                else:
                    cur_e = max(cur_e, e0)
            busy += (cur_e - cur_s) if cur_e is not None else 0.0
            window = spans[-1][1] - spans[0][0]
            key = f"{plane.name} | {line.name}"
            top_items = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
            out[key] = {"busy_share": busy / window if window else 0.0,
                        "window_ms": window / 1e6,
                        "top_ms": [(n[:90], v / 1e6) for n, v in top_items]}
            print(f"# trace {key}: window {window / 1e6:.3f} ms, busy "
                  f"{busy / max(window, 1):.3f}")
            for n, v in top_items:
                print(f"#   {v / 1e6:10.4f} ms  {n[:110]}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/fused_ab.json")
    ap.add_argument("--trace", default=None,
                    help="also write a profiler trace of 2 fused "
                         "headline steps here")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import bench
    from chip_smoke import _bench_wavefront
    from rust_pathtracer_tpu.integrator import T_MAX, T_MIN
    from rust_pathtracer_tpu.ops import fused_bounce as fb
    from rust_pathtracer_tpu.ops.intersect import (
        closest_hit_brute,
        closest_hit_static,
    )
    from rust_pathtracer_tpu.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu.utils import compcache
    from rust_pathtracer_tpu.utils.device import card_power, require_gpu

    device = require_gpu()
    compcache.enable()
    card = card_power()
    rec = {"device": device, "card": card}
    print(f"# card: {card}; device: {device}", flush=True)

    # ---- search alone: static sweep vs masked sweep -------------------
    scene, cols, _lk, _u = _bench_wavefront(0)
    o3 = jnp.stack([cols["o0"], cols["o1"], cols["o2"]], 1)
    d3 = jnp.stack([cols["d0"], cols["d1"], cols["d2"]], 1)
    f_static = jax.jit(lambda o, d: closest_hit_static(scene, o, d, T_MIN))
    f_masked = jax.jit(lambda o, d: closest_hit_brute(
        scene.prims, o, d, T_MIN, T_MAX, scene.prim_types))
    sweep = {}
    for name, f in (("static", f_static), ("masked", f_masked),
                    ("masked", f_masked), ("static", f_static)):
        ms, _ = _median_ms(f, (o3, d3))
        sweep.setdefault(name, []).append(ms)
        print(f"search {name} sweep (1M lanes, 20 prims): {ms:.4f} ms "
              f"[{card}]", flush=True)
    rec["search_ms"] = sweep

    # ---- end to end, compiled per route, timed in turns ---------------
    fused_ok = fb.fused_bounce_ok

    def set_route(fused):
        fb.fused_bounce_ok = fused_ok if fused else (lambda s: False)
        jax.clear_caches()

    routes = (("composed", False), ("fused", True))
    compiled = {"step": {}, "forward": {}}
    for name, fused in routes:
        set_route(fused)
        step, params, sc, settings, key = bench.make_step()
        t0 = time.perf_counter()
        compiled["step"][name] = (step.lower(params).compile(), (params,))
        print(f"# compiled step {name}: {time.perf_counter() - t0:.1f} s",
              flush=True)
        if args.trace and fused:
            import jax.profiler

            d = os.path.join(args.trace, name)
            c, a_ = compiled["step"][name]
            jax.block_until_ready(c(*a_))
            jax.profiler.start_trace(d)
            for _ in range(2):
                jax.block_until_ready(c(*a_))
            jax.profiler.stop_trace()
            rec.setdefault("trace", {})[name] = summarize_trace(d)
        nd = RenderSettings(bench.WIDTH, bench.HEIGHT, bench.SPP_CHUNK,
                            bench.MAX_BOUNCES, (0.0, 0.0, 0.0),
                            spp_chunk=bench.SPP_CHUNK)
        cam = params.camera.build()
        fwd = jax.jit(lambda s_, c_, k_: render_radiance(s_, c_, nd, k_)[0])
        t0 = time.perf_counter()
        compiled["forward"][name] = (fwd.lower(sc, cam, key).compile(),
                                     (sc, cam, key))
        print(f"# compiled forward {name}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    set_route(True)
    e2e = {"step": {}, "forward": {}}
    for metric in ("forward", "step"):
        names = [r[0] for r in routes]
        for name in names + names[::-1]:
            c, a_ = compiled[metric][name]
            ms, _ = _median_ms(c, a_)
            e2e[metric].setdefault(name, []).append(ms)
            print(f"{metric:7s} {name:9s}: {ms:.4f} ms  [{card}]",
                  flush=True)
    rec["end_to_end_ms"] = e2e
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()

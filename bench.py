"""Headline benchmark: rays/sec on CornellBox 512x512, forward+backward.

Prints exactly ONE JSON line:

  {"metric": ..., "value": N, "unit": "rays/s", "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": ...}, ...}

rays = ray SEGMENTS traced by the forward wavefront (the integrator
counts every alive lane at every bounce — the same unit a CPU tracer's
"rays cast" counter measures); time = wall clock of one jitted
forward+backward step (loss + gradients w.r.t. texture colors / texels /
camera / background), after compile + warmup, each step ended by
``block_until_ready``.

vs_baseline: the reference publishes NO numbers (BASELINE.md), so the
denominator is a documented ESTIMATE of the reference on a 16-core
CPU: RTiOW-style tracers run ~0.3-1.0 Mray/s/core on scenes of this
size; rayon across 16 cores => ~8 Mray/s (forward only; the reference
has no backward at all).

Runs on a GPU only: without one it exits non-zero and prints no result.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp

REFERENCE_CPU_RAYS_PER_SEC_ESTIMATE = 8.0e6

WIDTH = HEIGHT = 512
SPP_CHUNK = 4          # 512*512*4 = ~1M lanes per wavefront
MAX_BOUNCES = 20       # CornellBox setting (scene.rs:337)
REPS = 5               # steps per timed batch
N_BATCHES = 5          # initial timed batches (median reported)
MAX_BATCHES = 12       # extra batches drawn while spread > SPREAD_TOL
SPREAD_TOL = 0.10      # (max-min)/median across batches


def make_step():
    """(jitted value-and-grad step, params, scene) of the headline
    configuration; shared with chip_smoke.py."""
    from rust_pathtracer_tpu.grad import CameraParams, DiffParams, apply_params
    from rust_pathtracer_tpu.models import get_scene
    from rust_pathtracer_tpu.render import RenderSettings, render_radiance

    scene = get_scene("CornellBox").build()
    settings = RenderSettings(
        width=WIDTH,
        height=HEIGHT,
        samples_per_pixel=SPP_CHUNK,
        max_bounces=MAX_BOUNCES,
        background=(0.0, 0.0, 0.0),
        spp_chunk=SPP_CHUNK,
        differentiable=True,
    )
    cam_params = CameraParams.create(
        (278.0, 278.0, -800.0), (278.0, 278.0, 0.0), (0.0, 1.0, 0.0),
        40.0, 1.0, 0.0, 10.0,
    )
    params = DiffParams.from_scene(scene, cam_params, settings.background)
    key = jax.random.PRNGKey(0)

    def loss_and_aux(params):
        s = apply_params(scene, params)
        img, stats = render_radiance(
            s, params.camera.build(), settings, key, background=params.background
        )
        # mean-brightness objective: nonzero cotangents everywhere
        return jnp.mean(img), (stats.segments, img)

    step = jax.jit(jax.value_and_grad(loss_and_aux, has_aux=True))
    return step, params, scene, settings, key


def main():
    from rust_pathtracer_tpu.utils import compcache
    from rust_pathtracer_tpu.utils.device import card_power, require_gpu

    device = require_gpu()
    compcache.enable()
    step, params, _scene, _settings, _key = make_step()

    # compile + warmup
    t0 = time.perf_counter()
    (loss, (segments, _img)), grads = jax.block_until_ready(step(params))
    compile_s = time.perf_counter() - t0
    segs = float(segments)
    print(
        f"# warmup ok ({compile_s:.1f} s incl. compile): loss="
        f"{float(loss):.5f} segments/pass={segs:.0f} "
        f"avg_depth={segs / (WIDTH * HEIGHT * SPP_CHUNK):.2f}",
        file=sys.stderr,
    )

    # Median-of-batches timing with a spread guard: each batch is REPS
    # steps ended by block_until_ready; the reported number is the
    # MEDIAN batch, and while the relative spread (max-min)/median
    # exceeds SPREAD_TOL extra batches are drawn.
    def one_batch():
        t0 = time.perf_counter()
        out = None
        for _ in range(REPS):
            out = step(params)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / REPS

    times = sorted(one_batch() for _ in range(N_BATCHES))

    def spread(ts):
        return (ts[-1] - ts[0]) / ts[len(ts) // 2]

    while spread(times) > SPREAD_TOL and len(times) < MAX_BATCHES:
        times.append(one_batch())
        times.sort()
    dt = times[len(times) // 2]

    try:
        load1 = os.getloadavg()[0]
    except OSError:
        load1 = -1.0

    rays_per_sec = segs / dt
    card = card_power()
    print(
        f"# fwd+bwd step: median {dt * 1e3:.3f} ms over {len(times)} "
        f"batches of {REPS} (min {times[0]*1e3:.3f}, max "
        f"{times[-1]*1e3:.3f}, spread {spread(times)*100:.1f}%) for "
        f"{segs:.0f} segments; load1={load1:.1f}; card: {card}",
        file=sys.stderr,
    )
    print(
        json.dumps(
            {
                "metric": "rays/sec CornellBox 512^2 fwd+bwd",
                "value": rays_per_sec,
                "unit": "rays/s",
                "vs_baseline": rays_per_sec / REFERENCE_CPU_RAYS_PER_SEC_ESTIMATE,
                "step_ms": dt * 1e3,
                "timing_batches": len(times),
                "timing_spread": round(spread(times), 4),
                "host_load1": round(load1, 2),
                "card": card,
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # noqa: BLE001 — report, then fail loudly
        print(f"bench.py: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)

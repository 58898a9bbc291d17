#!/usr/bin/env python3
"""On-card smoke test: the renderer's main paths at full width on a GPU.

    python chip_smoke.py          # one GPU: every single-card phase
    python chip_smoke.py --four   # four GPUs: the sharded (--mesh) path only

One process drives the card.  Each phase prints what it checked and
its tolerances; any failed phase makes the script exit 1.  Without a
GPU (or without this repository's package beside it) the script exits
non-zero before any phase and prints no result.  On success the last
line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Single-card phases (width: the renderer's 1,048,576-lane chunks):

1. device — platform, device_kind, count, JAX version, the card's
   name and power limit (nvidia-smi), the compile cache directory;
2. headline — bench.py's CornellBox 512^2 fwd+bwd step (3 steps):
   finite loss and gradients, gradients not all zero, and the
   diff-mode forward image equal to a nondiff render of the same key;
3. cli — a judged CornellBox 512^2 @ 64 spp frame through cli.main,
   its PNG read back;
4. bvh — ModelTest (10k-triangle OBJ, cascade "auto") and SphereField
   1280x720 through the BVH traversal: finite, overflow slot 0;
5. regen — LightTest 512^2, 50 bounces, 16 spp through the
   regeneration wavefront;
6. reference — CornellBox 40x40 vs the independent f64 oracle, the
   pinned CPU means, same-key bitwise determinism;
7. parity — the fused bounce (the route of every small table-free
   scene; plain jnp left to XLA, no hand-written kernel) vs the
   composed jnp path and the masked (R, P) sweep on the CornellBox
   bench wavefront (1M lanes), and the step's gradients through each;
   every matmul of the step checked for HIGHEST precision (no float32
   contraction in TF32).

--four: render_radiance_sharded (CornellBox 512^2 @ 16 spp) on 4x1
and 2x2 meshes vs the single-card render, the sharded fwd+bwd step vs
single-card gradients, and a sharded cascade "auto" render forced
through the overflow retry.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# (name, background, mean on the CPU @ 64x64x16spp, 10 bounces,
# PRNGKey(0); the CPU runs the card's route, the fused bounce)
PINNED_MEANS = [
    ("CornellBox", (0.0, 0.0, 0.0), 0.151536),
    ("LightTest", (0.0, 0.0, 0.0), 0.104598),
    ("TwoSphereCheckers", (1.0, 1.0, 1.0), 0.405660),
]
PINNED_REL_TOL = 1e-3

# phase sizes (the headline and parity phases use bench.py's)
CLI_SIZE, CLI_SPP = 512, 64
MODEL_SIZE, MODEL_SPP = 512, 4
FIELD_W, FIELD_H = 1280, 720
LIGHT_SIZE, LIGHT_SPP, LIGHT_BOUNCES = 512, 16, 50
ORACLE_RES = 40
FOUR_SIZE, FOUR_SPP = 512, 16


class PhaseFailure(AssertionError):
    """A check inside a phase did not hold."""


def check(cond, msg):
    if not cond:
        raise PhaseFailure(msg)


def _block(x):
    import jax

    return jax.block_until_ready(x)


def _finite_tree(tree):
    import jax
    import numpy as np

    return all(bool(np.isfinite(np.asarray(l)).all())
               for l in jax.tree_util.tree_leaves(tree))


def _max_abs_tree(tree):
    import jax
    import numpy as np

    return max(float(np.abs(np.asarray(l)).max())
               for l in jax.tree_util.tree_leaves(tree))


def _timed(fn, *a, **k):
    t0 = time.perf_counter()
    out = _block(fn(*a, **k))
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# single-card phases
# ---------------------------------------------------------------------------

def phase_device(ctx):
    import jax

    from rust_pathtracer_tpu.utils import compcache
    from rust_pathtracer_tpu.utils.device import card_power, require_gpu

    dev = require_gpu()
    ctx["device"] = dev
    ctx["card"] = card_power()
    print(f"device: platform={dev['platform']} kind={dev['kind']} "
          f"count={dev['count']} jax={jax.__version__}")
    print(f"card (name, power.limit): {ctx['card']}")
    print(f"compile cache: {compcache.enable()}")
    print("fused bounce: one plain-jnp body left to XLA for the plain and "
          "the residual-writing bounce; no hand-written kernel")


def phase_headline(ctx):
    import jax
    import numpy as np

    import bench
    from rust_pathtracer_tpu.grad import apply_params
    from rust_pathtracer_tpu.render import render_radiance

    step, params, scene, settings, key = bench.make_step()
    out, t_compile = _timed(step, params)
    times = []
    for _ in range(3):
        out, dt = _timed(step, params)
        times.append(dt)
    (loss, (segments, img)), grads = out
    print(f"  first step (incl. compile) {t_compile:.3f} s; steps "
          f"{[round(t * 1e3, 3) for t in times]} ms; segments "
          f"{float(segments):.0f}; card {ctx['card']}")
    check(bool(np.isfinite(float(loss))), f"loss not finite: {loss}")
    check(_finite_tree(grads), "non-finite gradient leaf")
    gmax = _max_abs_tree(grads)
    check(gmax > 0.0, "all gradients are zero")
    print(f"  loss {float(loss):.6f}; max |grad| {gmax:.6g}; all leaves "
          "finite")

    nondiff = dataclasses.replace(settings, differentiable=False)
    img_nd, _ = render_radiance(
        apply_params(scene, params), params.camera.build(), nondiff, key,
        background=params.background,
    )
    a, b = np.asarray(img), np.asarray(img_nd)
    diff = np.abs(a - b)
    print(f"  diff-mode forward vs nondiff render (same key): bitwise "
          f"equal {bool((a == b).all())}; max |d| {diff.max():.3g}, mean "
          f"|d| {diff.mean():.3g}, pixels that differ "
          f"{float((diff.max(axis=-1) > 0).mean()):.4%} (tolerance: "
          "bitwise; both trace the same fused body)")
    check((a == b).all(), "diff-mode forward differs from the nondiff render")
    ctx["headline"] = (step, params, scene, settings, key, grads)


def phase_cli(ctx):
    import numpy as np

    from rust_pathtracer_tpu import cli
    from rust_pathtracer_tpu.utils.image import frame_path, read_png

    out = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    t0 = time.perf_counter()
    rc = cli.main(["--scene", "CornellBox", "--width", str(CLI_SIZE),
                   "--height", str(CLI_SIZE), "--spp", str(CLI_SPP),
                   "--output-dir", out, "--quiet"])
    dt = time.perf_counter() - t0
    check(rc == 0, f"cli.main returned {rc}")
    rgb = read_png(frame_path(out, 0))
    print(f"  CornellBox {CLI_SIZE}^2 @ {CLI_SPP} spp via cli.main in "
          f"{dt:.3f} s incl. compile; PNG {rgb.shape}, mean "
          f"{rgb.mean():.2f}/255; card {ctx['card']}")
    check(rgb.shape == (CLI_SIZE, CLI_SIZE, 3), f"PNG shape {rgb.shape}")
    check(rgb.mean() > 10.0, "PNG is (nearly) black")


def phase_bvh(ctx):
    import jax
    import numpy as np

    from rust_pathtracer_tpu.models import get_scene
    from rust_pathtracer_tpu.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu.scene.obj_loader import write_benchmark_obj

    objp = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_obj_"),
                        "model.obj")
    ntri = write_benchmark_obj(objp)
    key = jax.random.PRNGKey(0)
    cases = [
        ("ModelTest", {"obj_path": objp},
         dict(width=MODEL_SIZE, height=MODEL_SIZE,
              samples_per_pixel=MODEL_SPP, max_bounces=20,
              cascade_schedule="auto")),
        ("SphereField", {},
         dict(width=FIELD_W, height=FIELD_H, samples_per_pixel=1,
              max_bounces=20)),
    ]
    for name, kw, cfg in cases:
        sd = get_scene(name, **kw)
        scene = sd.build()
        check(scene.bvh is not None, f"{name} built without a BVH")
        s = RenderSettings(background=sd.output.image.background, **cfg)
        (img, stats), dt = _timed(render_radiance, scene, sd.camera_at(0.0),
                                  s, key)
        a = np.asarray(img)
        overflow = float(stats.occupancy[-1])
        lanes = s.width * s.height * s.resolve_chunk()
        extra = f" ({ntri} triangles)" if name == "ModelTest" else ""
        print(f"  {name}{extra} {s.width}x{s.height} @ "
              f"{s.samples_per_pixel} spp, {lanes} lanes/chunk, "
              f"{scene.num_prims} prims: {dt:.3f} s incl. compile, mean "
              f"{a.mean():.5f}, segments {float(stats.segments):.0f}, "
              f"overflow slot {overflow:.0f}")
        check(np.isfinite(a).all(), f"{name}: non-finite pixels")
        check(a.mean() > 0.0, f"{name}: black image")
        check(overflow == 0.0, f"{name}: cascade overflow {overflow}")


def phase_regen(ctx):
    import jax
    import numpy as np

    from rust_pathtracer_tpu.models import get_scene
    from rust_pathtracer_tpu.render import RenderSettings
    from rust_pathtracer_tpu.wavefront import render_radiance_regen

    sd = get_scene("LightTest")
    s = RenderSettings(LIGHT_SIZE, LIGHT_SIZE, LIGHT_SPP, LIGHT_BOUNCES,
                       sd.output.image.background)
    (img, stats), dt = _timed(render_radiance_regen, sd.build(),
                              sd.camera_at(0.0), s, jax.random.PRNGKey(0))
    a = np.asarray(img)
    print(f"  LightTest {LIGHT_SIZE}^2 @ {LIGHT_SPP} spp, {LIGHT_BOUNCES} "
          f"bounces, regen pool {min(LIGHT_SIZE ** 2 * LIGHT_SPP, 1 << 20)} "
          f"lanes: {dt:.3f} s incl. compile, mean {a.mean():.5f}, "
          f"{int(stats.bounces)} loop iterations, segments "
          f"{float(stats.segments):.0f}")
    check(np.isfinite(a).all(), "non-finite pixels")
    check(a.mean() > 0.0, "black image")


def phase_reference(ctx):
    import jax
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import oracle

    from rust_pathtracer_tpu.models import get_scene
    from rust_pathtracer_tpu.render import RenderSettings, render_radiance

    # statistical rule of tests/test_oracle_parity.py at 40x40
    res, spp = ORACLE_RES, 48
    oracle_mean = float(np.mean([
        oracle.render_oracle(oracle.cornell_prims(), oracle.cornell_camera(),
                             res, res, spp, 12, (0, 0, 0), seed=k).mean()
        for k in (1, 2, 3)
    ]))
    oracle_img = oracle.render_oracle(
        oracle.cornell_prims(), oracle.cornell_camera(), res, res, spp, 12,
        (0, 0, 0), seed=1,
    )
    sd = get_scene("CornellBox")
    scene = sd.build()
    ours, _ = render_radiance(scene, sd.camera_at(0.0),
                              RenderSettings(res, res, 4 * spp, 12,
                                             (0.0, 0.0, 0.0)),
                              jax.random.PRNGKey(0))
    ours = np.asarray(ours, np.float64)
    rel = abs(ours.mean() - oracle_mean) / oracle_mean
    mad = float(np.abs(ours - oracle_img).mean())
    print(f"  oracle (f64 numpy) CornellBox {res}x{res}: mean rel err {rel:.4f} "
          f"(tol 0.06 vs 3-seed oracle mean), per-pixel MAD {mad:.4f} "
          "(tol 0.12)")
    check(rel < 0.06 and mad < 0.12, "CornellBox disagrees with the oracle")

    for name, bg, pin in PINNED_MEANS:
        sdp = get_scene(name)
        sc = sdp.build()
        s = RenderSettings(64, 64, 16, 10, bg)
        img, _ = render_radiance(sc, sdp.camera_at(0.0), s,
                                 jax.random.PRNGKey(0))
        img2, _ = render_radiance(sc, sdp.camera_at(0.0), s,
                                  jax.random.PRNGKey(0))
        a, a2 = np.asarray(img), np.asarray(img2)
        r = abs(float(a.mean()) - pin) / pin
        same = bool((a == a2).all())
        print(f"  {name} 64x64 @ 16 spp: mean {a.mean():.6f} vs CPU pin "
              f"{pin:.6f} (rel {r:.2e}, tol {PINNED_REL_TOL:g}); same key "
              f"twice bitwise identical: {same}")
        check(np.isfinite(a).all(), f"{name}: non-finite pixels")
        check(r < PINNED_REL_TOL, f"{name}: mean off the CPU pin")
        check(same, f"{name}: same key rendered two different images")


def _bench_wavefront(bounces_before):
    """CornellBox bench lanes (bench.py: 512^2 x 4 spp = 1M) advanced
    ``bounces_before`` fused bounces: (scene, cols, lane keys,
    uniform columns for the next bounce)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from rust_pathtracer_tpu import sampling
    from rust_pathtracer_tpu.integrator import T_MIN
    from rust_pathtracer_tpu.models import get_scene
    from rust_pathtracer_tpu.ops import fused_bounce as fb
    from rust_pathtracer_tpu.render import _make_lanes

    sd = get_scene("CornellBox")
    scene = sd.build()
    w, h, spp = bench.WIDTH, bench.HEIGHT, bench.SPP_CHUNK
    pix = np.arange(w * h, dtype=np.uint32)
    lk, o, d, _ = _make_lanes(sd.camera_at(0.0), jax.random.PRNGKey(0),
                              pix, jnp.uint32(0), width=w, height=h,
                              spp_chunk=spp, spp_total=spp)
    ones = jnp.ones_like(o[:, 0])
    zeros = jnp.zeros_like(o[:, 0])
    cols = dict(zip(fb._COL_KEYS, (
        o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
        ones, ones, ones, zeros, zeros, zeros, ones,
    )))

    def uniforms(b):
        su, bu, cn, _ = sampling.bounce_draws(lk, b, False)
        return su[:, 0], su[:, 1], bu[:, 0], bu[:, 1], bu[:, 2], cn

    for b in range(bounces_before):
        cols = fb.fused_bounce_cols_step(
            scene, cols, *uniforms(b), (0.0, 0.0, 0.0), T_MIN, False
        )
    return scene, cols, lk, uniforms(bounces_before)


def _dot_precisions(jaxpr, out):
    """Collect the precision of every dot_general in a (closed) jaxpr,
    sub-jaxprs included."""
    from jax.extend import core as jcore

    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append((eqn.params.get("precision"),
                        str(eqn.invars[0].aval.dtype)))
        for v in eqn.params.values():
            subs = v if isinstance(v, (list, tuple)) else [v]
            for sub in subs:
                if isinstance(sub, jcore.ClosedJaxpr):
                    _dot_precisions(sub.jaxpr, out)
                elif isinstance(sub, jcore.Jaxpr):
                    _dot_precisions(sub, out)
    return out


def phase_parity(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from rust_pathtracer_tpu.integrator import (
        MAX_BOUNCE_STATS,
        T_MAX,
        T_MIN,
        _bounce_step,
    )
    from rust_pathtracer_tpu.ops import fused_bounce as fb
    from rust_pathtracer_tpu.ops.intersect import closest_hit_brute

    fused_ok = fb.fused_bounce_ok
    for b0 in (0, 3):
        scene, cols, lk, u = _bench_wavefront(b0)
        packed = fb.pack_prims_shaded(scene)
        bg = jnp.zeros((3,), jnp.float32)
        seed = jnp.asarray(scene.textures.perlin_seed, jnp.uint32)
        outs = {}
        for want_res in (False, True):
            outs[want_res] = _block(fb._fused_bounce_cols(
                packed, bg, seed, cols, *u, kinds=scene.kinds_static,
                mat_types=scene.mat_types, tex_types=scene.tex_types,
                t_min=float(T_MIN), want_residuals=want_res,
            ))
        plain, (out, res) = outs[False], outs[True]
        n_res = sum(int((np.asarray(plain[k]) != np.asarray(out[k])).sum())
                    for k in fb._COL_KEYS)
        flags = np.asarray(res["flags"])
        alive = np.asarray(cols["al"]) > 0.5
        hit_f = (flags & fb.FLG_HIT) != 0
        idx_f = flags >> fb.FLG_BESTI_SHIFT
        # the masked (R, P) sweep on the same rays
        o3 = jnp.stack([cols["o0"], cols["o1"], cols["o2"]], 1)
        d3 = jnp.stack([cols["d0"], cols["d1"], cols["d2"]], 1)
        hb, _tb, ib = closest_hit_brute(scene.prims, o3, d3, T_MIN,
                                        T_MAX, scene.prim_types)
        hb = np.asarray(hb) & alive
        n_hit = int((hb != hit_f).sum())
        both = hb & hit_f
        n_idx = int((np.asarray(ib)[both] != idx_f[both]).sum())
        # the composed jnp bounce (scene routed off the fused body)
        state = dict(
            o=o3, d=d3,
            thr=jnp.stack([cols["t0"], cols["t1"], cols["t2"]], 1),
            rad=jnp.stack([cols["r0"], cols["r1"], cols["r2"]], 1),
            alive=cols["al"] > 0.5, segments=jnp.float32(0.0),
            occupancy=jnp.zeros((MAX_BOUNCE_STATS,), jnp.float32),
        )
        draws = dict(sphere_u=jnp.stack(u[:2], 1),
                     ball_u=jnp.stack(u[2:5], 1), coin=u[5])
        try:
            fb.fused_bounce_ok = lambda s: False
            ref = _block(jax.jit(lambda st: _bounce_step(
                scene, lk, bg, 99, st, jnp.int32(b0), draws=draws))(state))
        finally:
            fb.fused_bounce_ok = fused_ok
        al_c = np.asarray(ref["alive"])
        n_alive = int((al_c != (np.asarray(out["al"]) > 0.5)).sum())
        n_bad, n_el, worst_a, worst_r = 0, 0, ("", 0.0), ("", 0.0)
        same = al_c == (np.asarray(out["al"]) > 0.5)
        for key, pre in (("o", "o"), ("d", "d"), ("thr", "t"),
                         ("rad", "r")):
            x = np.stack([np.asarray(out[f"{pre}{c}"]) for c in "012"],
                         1)[same]
            y = np.asarray(ref[key])[same]
            ae = np.abs(x - y)
            n_bad += int((ae > 1e-4 + 1e-3 * np.abs(y)).sum())
            n_el += ae.size
            big = np.abs(y) > 1e-3
            re = float((ae[big] / np.abs(y[big])).max()) if big.any() else 0.0
            if ae.max() > worst_a[1]:
                worst_a = (key, float(ae.max()))
            if re > worst_r[1]:
                worst_r = (key, re)
        print(f"  bounce {b0} ({int(alive.sum())} live of {alive.size} "
              f"lanes): residual-writing vs plain fused bounce, state "
              f"elements that differ {n_res} (tolerance: none); vs the "
              f"masked sweep: hit-mask mismatches {n_hit}, winning-index "
              f"mismatches {n_idx} (tolerance 1e-5 of lanes)")
        print(f"    vs the composed jnp bounce (f32): alive mismatches "
              f"{n_alive}; on the other lanes largest abs err "
              f"{worst_a[1]:.3g} ({worst_a[0]}), largest rel err where "
              f"|value| > 1e-3 {worst_r[1]:.3g} ({worst_r[0]}), elements "
              f"outside |d| <= 1e-4 + 1e-3 |value|: {n_bad} of {n_el} "
              "(tolerance 1e-4 of lanes and of elements: other fusions, "
              "so a rare ulp flip of a discrete choice)")
        check(n_res == 0, "residual-writing bounce differs from the plain one")
        check(n_hit <= alive.size * 1e-5 and n_idx <= alive.size * 1e-5,
              "fused search and masked sweep disagree beyond 1e-5 of lanes")
        check(n_alive <= alive.size * 1e-4 and n_bad <= n_el * 1e-4,
              "fused and composed bounce disagree beyond tolerance")

    # gradients of the headline step: fused route vs the composed path
    step, params, scene, settings, key, g_fused = ctx["headline"]
    try:
        fb.fused_bounce_ok = lambda s: False
        jax.clear_caches()
        step_c, params_c, *_ = bench.make_step()
        (_loss_c, _aux), g_comp = _block(step_c(params_c))
    finally:
        fb.fused_bounce_ok = fused_ok
        jax.clear_caches()
    worst = 0.0
    for gf, gc in zip(jax.tree_util.tree_leaves(g_fused),
                      jax.tree_util.tree_leaves(g_comp)):
        gf, gc = np.asarray(gf), np.asarray(gc)
        scale = max(float(np.abs(gc).max()), 1e-12)
        worst = max(worst, float(np.abs(gf - gc).max()) / scale)
    print(f"  headline gradients, fused custom VJP vs autodiff of the "
          f"composed path: largest leaf error / leaf max |g| = {worst:.3g} "
          "(tolerance 5e-3: same estimator; the forwards differ by ulps "
          "and rare rerouted paths)")
    check(worst <= 5e-3, "gradients differ between fused and composed path")

    precs = _dot_precisions(jax.make_jaxpr(step)(params).jaxpr, [])
    bad = [p for p in precs
           if "HIGHEST" not in str(p[0]) and p[1] == "float32"]
    print(f"  matmuls in the headline step: {len(precs)}, float32 ones "
          f"not at Precision.HIGHEST: {len(bad)} (so none runs in TF32)")
    check(not bad, f"float32 matmul below HIGHEST precision: {bad}")


SINGLE_PHASES = [
    ("device", phase_device),
    ("headline", phase_headline),
    ("cli", phase_cli),
    ("bvh", phase_bvh),
    ("regen", phase_regen),
    ("reference", phase_reference),
    ("parity", phase_parity),
]


# ---------------------------------------------------------------------------
# four-card phases (--four)
# ---------------------------------------------------------------------------

def phase_sharded_render(ctx):
    import jax
    import numpy as np

    from rust_pathtracer_tpu.models import get_scene
    from rust_pathtracer_tpu.parallel import make_mesh, render_radiance_sharded
    from rust_pathtracer_tpu.render import RenderSettings, render_radiance

    check(len(jax.devices()) >= 4, f"need 4 GPUs, found {len(jax.devices())}")
    sd = get_scene("CornellBox")
    scene = sd.build()
    cam = sd.camera_at(0.0)
    key = jax.random.PRNGKey(0)
    s = RenderSettings(FOUR_SIZE, FOUR_SIZE, FOUR_SPP, 20, (0.0, 0.0, 0.0))
    single, dt1 = _timed(lambda: render_radiance(
        scene, cam, s, key, background=None)[0])
    a = np.asarray(single)
    for tiles, samples in ((4, 1), (2, 2)):
        mesh = make_mesh(tiles=tiles, samples=samples,
                         devices=jax.devices()[:4])
        img, dt = _timed(lambda: render_radiance_sharded(
            scene, cam, s, key, mesh)[0])
        b = np.asarray(img)
        d = np.abs(a - b)
        print(f"  CornellBox {FOUR_SIZE}^2 @ {FOUR_SPP} spp, mesh "
              f"{tiles}x{samples}: "
              f"{dt:.3f} s incl. compile (single card {dt1:.3f} s); "
              f"bitwise equal to single card: {bool((a == b).all())}; "
              f"max |d| {d.max():.3g}, mean |d| {d.mean():.3g}")
        # same (pixel, sample) lanes and counters on every layout; only
        # the samples-axis psum changes the f32 summation order
        check(d.max() <= 1e-5, "sharded render differs from single card "
              "beyond f32 summation-order tolerance (1e-5)")


def phase_sharded_step(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from rust_pathtracer_tpu.grad import apply_params
    from rust_pathtracer_tpu.parallel import make_mesh, render_radiance_sharded

    step, params, scene, settings, key = bench.make_step()
    (loss1, _aux), g1 = _block(step(params))
    mesh = make_mesh(tiles=2, samples=2, devices=jax.devices()[:4])

    def loss_sharded(p):
        img, _ = render_radiance_sharded(
            apply_params(scene, p), p.camera.build(), settings, key, mesh,
            background=p.background,
        )
        return jnp.mean(img)

    sstep = jax.jit(jax.value_and_grad(loss_sharded))
    (loss4, g4), dt = _timed(sstep, params)
    worst = 0.0
    for a, b in zip(jax.tree_util.tree_leaves(g1),
                    jax.tree_util.tree_leaves(g4)):
        a, b = np.asarray(a), np.asarray(b)
        worst = max(worst, float(np.abs(a - b).max())
                    / max(float(np.abs(a).max()), 1e-12))
    print(f"  headline fwd+bwd on a 2x2 mesh: {dt:.3f} s incl. compile; "
          f"loss {float(loss4):.6f} vs single {float(loss1):.6f}; largest "
          f"gradient leaf error / leaf max |g| = {worst:.3g} (tolerance "
          "1e-4: per-shard partial sums are psum'd in another order)")
    check(abs(float(loss4) - float(loss1)) <= 1e-5 * abs(float(loss1)),
          "sharded loss differs")
    check(worst <= 1e-4, "sharded gradients differ from single card")


def phase_sharded_retry(ctx):
    import warnings

    import jax
    import numpy as np

    from rust_pathtracer_tpu import render as render_mod
    from rust_pathtracer_tpu.models import get_scene
    from rust_pathtracer_tpu.parallel import make_mesh, render_radiance_sharded
    from rust_pathtracer_tpu.render import RenderSettings

    sd = get_scene("CornellBox")
    scene = sd.build()
    cam = sd.camera_at(0.0)
    key = jax.random.PRNGKey(0)
    mesh = make_mesh(tiles=4, samples=1, devices=jax.devices()[:4])
    # four sample chunks: chunk 0 calibrates, the rest run cascaded
    plain = RenderSettings(FOUR_SIZE, FOUR_SIZE, FOUR_SPP, 20,
                           (0.0, 0.0, 0.0), spp_chunk=FOUR_SPP // 4)
    ref, _ = render_radiance_sharded(scene, cam, plain, key, mesh)
    auto = dataclasses.replace(plain, cascade_schedule="auto")
    orig = render_mod.AUTO_MARGIN
    try:
        render_mod.AUTO_MARGIN = 0.3  # too tight: forces the retry
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            img, stats = render_radiance_sharded(scene, cam, auto, key, mesh)
            img = _block(img)
    finally:
        render_mod.AUTO_MARGIN = orig
    retried = [str(w.message) for w in caught if "dropped" in str(w.message)]
    d = np.abs(np.asarray(img) - np.asarray(ref))
    print(f"  sharded cascade 'auto' at margin 0.3: {len(retried)} overflow "
          f"retries; image vs plain sharded render max |d| {d.max():.3g} "
          "(tolerance 1e-5: compaction reorders f32 sums only)")
    check(retried, "the overflow retry was not exercised")
    check(d.max() <= 1e-5, "retried cascade image differs from plain")


FOUR_PHASES = [
    ("device", phase_device),
    ("sharded_render", phase_sharded_render),
    ("sharded_step", phase_sharded_step),
    ("sharded_retry", phase_sharded_retry),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded phases")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    try:
        import jax  # noqa: F401

        from rust_pathtracer_tpu.utils.device import NoGpuError, require_gpu
    except ImportError as e:
        print(f"chip_smoke: cannot import the renderer ({e}); run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    try:
        require_gpu()
    except NoGpuError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 3

    ctx = {}
    failed = []
    phases = FOUR_PHASES if args.four else SINGLE_PHASES
    for name, fn in phases:
        print(f"== phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn(ctx)
        except Exception:  # noqa: BLE001 — any failure fails the phase
            failed.append(name)
            traceback.print_exc()
            print(f"== phase {name}: FAILED", flush=True)
            if name == "device":
                break
            continue
        print(f"== phase {name}: ok ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        try:
            import jax

            stats = jax.devices()[0].memory_stats() or {}
            print(f"   peak device memory so far: "
                  f"{stats.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB")
        except Exception:  # noqa: BLE001 — memory stats are optional
            pass
    if failed:
        print(f"chip_smoke: FAILED phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": ctx["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

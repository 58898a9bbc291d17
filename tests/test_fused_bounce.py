"""Fused whole bounce vs the composed jnp path.

The fused bounce (ops/fused_bounce.py) runs search + record + texture +
scatter + state commit as one function left to XLA; it is the route
for small table-free scenes on every backend.  Contract vs the
composed path: hit/alive masks EXACT, floats to fusion-rounding
tolerance.  The reference here is the composed path on the same scene,
reached by routing the scene off the fused bounce
(``fused_bounce_ok`` patched to refuse it).
"""

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest

from rust_pathtracer_tpu import sampling
from rust_pathtracer_tpu.integrator import trace
from rust_pathtracer_tpu.models import get_scene
from rust_pathtracer_tpu.ops import fused_bounce as fb
from rust_pathtracer_tpu.scene.builder import SceneBuilder

KEY = jax.random.PRNGKey(7)


_FUSED_OK = fb.fused_bounce_ok


def _route(monkeypatch, fused):
    """Route eligible scenes through the fused bounce (the default) or
    the composed path, and drop jit caches traced under the other."""
    monkeypatch.setattr(fb, "fused_bounce_ok",
                        _FUSED_OK if fused else (lambda scene: False))
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _no_route_leak():
    """A test that stops under the composed route leaves no jit cache
    traced under it."""
    yield
    jax.clear_caches()


def _lane_keys(n, seed=0):
    return sampling.lane_keys(
        jax.random.PRNGKey(seed), jnp.arange(n, dtype=jnp.uint32)
    )


def _full_scene():
    """Every material kind + solid/checker/perlin textures + every
    primitive kind — the fused bounce's whole routing surface."""
    b = SceneBuilder()
    checker = b.checker_texture(
        b.solid_texture((0.2, 0.3, 0.1)), b.solid_texture((0.9, 0.9, 0.9))
    )
    perlin = b.perlin_texture(4.0)
    b.add_sphere((0, -100.5, -3), 100.0, b.lambertian(checker))
    b.add_sphere((0, 0.5, -3), 0.5, b.lambertian(perlin))
    b.add_sphere((1.2, 0.5, -3), 0.5, b.metal((0.8, 0.7, 0.6), fuzz=0.2))
    b.add_sphere((-1.2, 0.5, -3), 0.5, b.dielectric(1.5))
    b.add_sphere((-1.2, 0.5, -3), -0.4, b.dielectric(1.5))  # hollow shell
    b.add_rect("xz", (-2, 3.0, -5), (2, 3.0, -1), -1.0,
               b.diffuse_light((4, 4, 4)))
    b.add_triangle((2.2, 0.0, -4), (3.2, 0.0, -4), (2.7, 1.2, -4),
                   b.lambertian((0.6, 0.2, 0.2)))
    return b.build(use_bvh=False)


def _rays(n):
    ang = jnp.linspace(-0.5, 0.5, n)
    o = jnp.tile(jnp.asarray([[0.0, 0.8, 1.5]]), (n, 1))
    d = jnp.stack(
        [jnp.sin(ang), 0.3 * jnp.cos(5 * ang) - 0.3, -jnp.cos(ang)], axis=1
    )
    return o, d


def test_scene_flags():
    scene = _full_scene()
    assert scene.shade_static
    assert scene.kinds_static is not None
    for name in ("CornellBox", "TriangleTest", "LightTest",
                 "TwoSphereCheckers"):
        sd = get_scene(name)
        s = sd.build()
        assert s.shade_static, name
        assert s.kinds_static is not None, name

    # image textures must opt OUT
    b = SceneBuilder()
    img = np.linspace(0, 1, 4 * 4 * 3).reshape(4, 4, 3).astype(np.float32)
    b.add_sphere((0, 0, -3), 1.0, b.lambertian(b.image_texture(img)))
    assert not b.build(use_bvh=False).shade_static


def _compare_diverging(rad0, rad1, st0, st1, max_flip_frac=0.02):
    """Multi-bounce fused-vs-composed comparison.

    The fused bounce's floats agree with the composed path only to a
    few ulp (different fusions) — and over multiple bounces an ulp flip of a DISCRETE choice (dielectric coin,
    metal grazing test) reroutes that lane's whole path.  So the
    contract here is statistical: almost every lane identical to
    tolerance, a tiny flipped fraction allowed, means tight, segment
    counts within the flipped fraction."""
    r0, r1 = np.asarray(rad0), np.asarray(rad1)
    lane_diff = np.abs(r1 - r0).max(axis=-1)
    scale = np.abs(r0).max(axis=-1) + 1e-3
    flipped = lane_diff > 1e-3 * scale
    assert flipped.mean() <= max_flip_frac, flipped.mean()
    np.testing.assert_allclose(r1.mean(axis=0), r0.mean(axis=0), rtol=0.03,
                               atol=5e-3)
    s0, s1 = float(st0.segments), float(st1.segments)
    assert abs(s1 - s0) <= max(8.0, 0.05 * s0), (s0, s1)


def test_fused_bounce_matches_trace(monkeypatch):
    """Full multi-bounce trace through the fused bounce vs the
    composed path: statistically identical (see _compare_diverging)."""
    scene = _full_scene()
    o, d = _rays(192)
    keys = _lane_keys(192)
    bg = (0.3, 0.4, 0.5)
    _route(monkeypatch, False)
    rad0, st0 = trace(scene, o, d, keys, bg, max_bounces=8)
    _route(monkeypatch, True)
    rad1, st1 = trace(scene, o, d, keys, bg, max_bounces=8)
    _compare_diverging(rad0, rad1, st0, st1)


def test_fused_bounce_roulette_matches(monkeypatch):
    scene = _full_scene()
    o, d = _rays(128)
    keys = _lane_keys(128, seed=3)
    bg = (0.1, 0.1, 0.1)
    _route(monkeypatch, False)
    rad0, st0 = trace(scene, o, d, keys, bg, max_bounces=10,
                      russian_roulette_start=3)
    _route(monkeypatch, True)
    rad1, st1 = trace(scene, o, d, keys, bg, max_bounces=10,
                      russian_roulette_start=3)
    _compare_diverging(rad0, rad1, st0, st1)


def test_fused_bounce_single_step_exact_masks(monkeypatch):
    """One bounce: alive-out mask and banked radiance must agree with
    the composed path lane-for-lane (mask exact, floats tight)."""
    from rust_pathtracer_tpu.integrator import MAX_BOUNCE_STATS, _bounce_step

    scene = _full_scene()
    o, d = _rays(256)
    keys = _lane_keys(256, seed=11)
    zeros3 = o * 0.0
    state = dict(
        o=o, d=d, thr=zeros3 + 1.0, rad=zeros3,
        alive=zeros3[..., 0] == 0.0,
        segments=jnp.float32(0.0),
        occupancy=jnp.zeros((MAX_BOUNCE_STATS,), jnp.float32),
    )
    bg = jnp.asarray((0.2, 0.1, 0.05), jnp.float32)
    _route(monkeypatch, False)
    out0 = _bounce_step(scene, keys, bg, 99, dict(state), jnp.int32(0))
    _route(monkeypatch, True)
    out1 = _bounce_step(scene, keys, bg, 99, dict(state), jnp.int32(0))
    assert np.array_equal(np.asarray(out1["alive"]), np.asarray(out0["alive"]))
    # float tolerance: the two compilations contract FMAs differently;
    # the r=100 ground sphere's |oc|^2 - r^2 cancellation amplifies a
    # t ulp to ~1e-4 relative, and perlin's sin(10*turb(p)) amplifies
    # the hit-point ulp similarly — honest contract, not slack
    for k in ("o", "d", "thr", "rad"):
        np.testing.assert_allclose(
            np.asarray(out1[k]), np.asarray(out0[k]), rtol=1e-3, atol=1e-4,
            err_msg=k,
        )


def test_fused_bounce_cornellbox_render(monkeypatch):
    """End-to-end CornellBox render through the fused bounce."""
    from rust_pathtracer_tpu.render import RenderSettings, render_radiance

    sd = get_scene("CornellBox")
    scene = sd.build()
    cam = sd.camera_at(0.0)
    s = RenderSettings(24, 24, 4, 8, (0.0, 0.0, 0.0))
    _route(monkeypatch, False)
    img0, st0 = render_radiance(scene, cam, s, KEY)
    _route(monkeypatch, True)
    img1, st1 = render_radiance(scene, cam, s, KEY)
    _compare_diverging(
        np.asarray(img0).reshape(-1, 3), np.asarray(img1).reshape(-1, 3),
        st0, st1,
    )


def test_fused_bounce_regen_lighttest(monkeypatch):
    """Regen wavefront through the fused bounce vs the composed path:
    LightTest-style scene (perlin ground + one-sided rect lights)."""
    from rust_pathtracer_tpu.render import RenderSettings
    from rust_pathtracer_tpu.wavefront import render_radiance_regen

    sd = get_scene("LightTest")
    scene = sd.build()
    cam = sd.camera_at(0.0)
    s = RenderSettings(20, 12, 8, 12, (0.0, 0.0, 0.0))
    _route(monkeypatch, False)
    img0, st0 = render_radiance_regen(scene, cam, s, KEY, lanes=1024,
                                      flush_every=2)
    _route(monkeypatch, True)
    img1, st1 = render_radiance_regen(scene, cam, s, KEY, lanes=1024,
                                      flush_every=2)
    _compare_diverging(
        np.asarray(img0).reshape(-1, 3), np.asarray(img1).reshape(-1, 3),
        st0, st1, max_flip_frac=0.05,
    )


def _solid_checker_scene():
    """Fused-DIFF-eligible scene: solid + checker textures only, all
    four materials (no perlin/image — fused_bounce_diff_ok gates)."""
    b = SceneBuilder()
    checker = b.checker_texture(
        b.solid_texture((0.2, 0.3, 0.1)), b.solid_texture((0.9, 0.9, 0.9))
    )
    b.add_sphere((0, -100.5, -3), 100.0, b.lambertian(checker))
    b.add_sphere((0, 0.5, -3), 0.5, b.lambertian((0.5, 0.3, 0.2)))
    b.add_sphere((1.2, 0.5, -3), 0.5, b.metal((0.8, 0.7, 0.6), fuzz=0.2))
    b.add_sphere((-1.2, 0.5, -3), 0.5, b.dielectric(1.5))
    b.add_rect("xz", (-2, 3.0, -5), (2, 3.0, -1), -1.0,
               b.diffuse_light((4, 4, 4)))
    b.add_triangle((2.2, 0.0, -4), (3.2, 0.0, -4), (2.7, 1.2, -4),
                   b.lambertian((0.6, 0.2, 0.2)))
    return b.build(use_bvh=False)


def test_fused_bounce_vjp_finite_difference(monkeypatch):
    """The hand-written backward vs central finite differences of the
    FUSED forward itself (same forward -> same frozen discrete
    decisions, so FD measures exactly the derivative the detached
    estimator defines).  Covers g_o/g_d (incl. the analytic-t and
    sphere-normal chains), g_thr, packed color rows, and background."""
    from rust_pathtracer_tpu.integrator import T_MIN
    from rust_pathtracer_tpu.ops.fused_bounce import (
        _make_fused_bounce_vjp,
        pack_prims_shaded,
    )

    from rust_pathtracer_tpu.ops.fused_bounce import _COL_KEYS

    scene = _solid_checker_scene()
    R = 96
    o, d = _rays(R)
    keys = _lane_keys(R, seed=5)
    sph = sampling.uniform2(sampling.bounce_keys(keys, 0, 2))
    ball = sampling.uniform3(sampling.bounce_keys(keys, 0, 3))
    coin = sampling.uniform(sampling.bounce_keys(keys, 0, 4))
    thr = 0.5 + 0.5 * sampling.uniform(sampling.bounce_keys(keys, 1, 0))
    thr = jnp.stack([thr, thr * 0.8, thr * 0.6], 1)
    rad = jnp.zeros((R, 3))
    alive_f = jnp.ones((R,), jnp.float32)
    packed = pack_prims_shaded(scene)
    bg = jnp.asarray((0.25, 0.15, 0.35), jnp.float32)

    bounce = _make_fused_bounce_vjp(
        scene.kinds_static, scene.mat_types, scene.tex_types,
        float(T_MIN),
    )

    # fixed random cotangent weights on every output
    k = jax.random.PRNGKey(42)
    ws = [jax.random.normal(jax.random.fold_in(k, i), (R, 3))
          for i in range(4)]

    def loss(o_, d_, thr_, packed_, bg_):
        cols = dict(zip(_COL_KEYS, (
            o_[:, 0], o_[:, 1], o_[:, 2], d_[:, 0], d_[:, 1], d_[:, 2],
            thr_[:, 0], thr_[:, 1], thr_[:, 2],
            rad[:, 0], rad[:, 1], rad[:, 2], alive_f,
        )))
        c = bounce(cols, sph[:, 0], sph[:, 1], ball[:, 0], ball[:, 1],
                   ball[:, 2], coin, packed_, bg_)
        o2 = jnp.stack([c["o0"], c["o1"], c["o2"]], 1)
        d2 = jnp.stack([c["d0"], c["d1"], c["d2"]], 1)
        t2 = jnp.stack([c["t0"], c["t1"], c["t2"]], 1)
        r2 = jnp.stack([c["r0"], c["r1"], c["r2"]], 1)
        return (jnp.sum(ws[0] * o2) + jnp.sum(ws[1] * d2)
                + jnp.sum(ws[2] * t2) + jnp.sum(ws[3] * r2))

    val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4))(
        o, d, thr, packed, bg
    )
    names = ("o", "d", "thr", "packed", "bg")
    args = [np.asarray(x, np.float64) for x in (o, d, thr, packed, bg)]
    rng = np.random.default_rng(7)
    checked = 0
    for ai, g in enumerate(grads):
        g = np.asarray(g)
        flat = g.ravel()
        # sample coordinates with non-negligible gradients (f32 FD
        # cannot resolve tiny ones)
        idxs = np.argsort(-np.abs(flat))
        cand = [i for i in idxs[:40] if abs(flat[i]) > 1e-3]
        for i in rng.permutation(cand)[:8]:
            eps = max(1e-3 * abs(args[ai].ravel()[i]), 1e-4)

            def at(x):
                a2 = [a.copy() for a in args]
                a2[ai] = a2[ai].copy()
                a2[ai].ravel()[i] = x
                return float(loss(*[jnp.asarray(a, jnp.float32)
                                    for a in a2]))

            x0 = args[ai].ravel()[i]
            fd = (at(x0 + eps) - at(x0 - eps)) / (2 * eps)
            assert np.isclose(flat[i], fd, rtol=0.05, atol=1e-3), (
                names[ai], i, flat[i], fd)
            checked += 1
    assert checked >= 20  # the sampling must actually exercise slots


def test_fused_bounce_diff_matches_xla_grads(monkeypatch):
    """End-to-end loss+grads: fused-diff vs the composed diff
    path on a solid/checker scene.  Same statistical caveat as the
    forward comparisons (ulp path flips), so tolerances are loose-ish
    but far below any formula error."""
    import dataclasses

    from rust_pathtracer_tpu.grad import (
        CameraParams,
        DiffParams,
        render_loss_and_grad,
    )
    from rust_pathtracer_tpu.render import RenderSettings

    scene = _solid_checker_scene()
    cam = CameraParams.create(
        (0.0, 1.0, 2.0), (0.0, 0.5, -3.0), (0.0, 1.0, 0.0), 50.0, 1.0
    )
    settings = RenderSettings(16, 16, 4, 6, (0.1, 0.2, 0.3))
    params = DiffParams.from_scene(scene, cam, settings.background)
    target = jnp.zeros((16, 16, 3))

    _route(monkeypatch, False)
    loss0, g0 = render_loss_and_grad(params, scene, settings, KEY, target)
    _route(monkeypatch, True)
    loss1, g1 = render_loss_and_grad(params, scene, settings, KEY, target)
    np.testing.assert_allclose(float(loss1), float(loss0), rtol=2e-3)
    f0, _ = jax.flatten_util.ravel_pytree(g0)
    f1, _ = jax.flatten_util.ravel_pytree(g1)
    f0, f1 = np.asarray(f0), np.asarray(f1)
    assert np.abs(f0).max() > 0
    scale = np.abs(f0).max()
    np.testing.assert_allclose(f1, f0, rtol=0.05, atol=2e-3 * scale)


def test_fused_bounce_bf16_residuals(monkeypatch):
    """RPT_FBD_RES=bf16 (opt-in): residuals stored bfloat16.
    The PRIMAL loss is bitwise the f32-residual loss (residuals only
    feed the backward); gradients stay within a documented tolerance
    of the f32-residual gradients (cf. the round-3 compressed_vjp
    contract, tests/test_grad.py)."""
    from rust_pathtracer_tpu.grad import (
        CameraParams,
        DiffParams,
        render_loss_and_grad,
    )
    from rust_pathtracer_tpu.render import RenderSettings

    scene = _solid_checker_scene()
    cam = CameraParams.create(
        (0.0, 1.0, 2.0), (0.0, 0.5, -3.0), (0.0, 1.0, 0.0), 50.0, 1.0
    )
    settings = RenderSettings(16, 16, 4, 6, (0.1, 0.2, 0.3))
    params = DiffParams.from_scene(scene, cam, settings.background)
    target = jnp.zeros((16, 16, 3))

    _route(monkeypatch, True)
    loss0, g0 = render_loss_and_grad(params, scene, settings, KEY, target)
    monkeypatch.setenv("RPT_FBD_RES", "bf16")
    jax.clear_caches()
    loss1, g1 = render_loss_and_grad(params, scene, settings, KEY, target)
    monkeypatch.delenv("RPT_FBD_RES")
    # primal identical: residuals are a backward-only artifact
    np.testing.assert_array_equal(float(loss1), float(loss0))
    f0, _ = jax.flatten_util.ravel_pytree(g0)
    f1, _ = jax.flatten_util.ravel_pytree(g1)
    f0, f1 = np.asarray(f0), np.asarray(f1)
    assert np.abs(f0).max() > 0
    scale = np.abs(f0).max()
    # bf16 rounding of t/normal/value/ratio/invr: ~1e-2 normalized
    np.testing.assert_allclose(f1, f0, rtol=0.1, atol=2e-2 * scale)


@pytest.mark.parametrize("rr", [None, 4])
def test_fused_scan_vjp_matches_jax_transpose(monkeypatch, rr):
    """Whole-scan custom VJP (RPT_FBD_SCAN=vjp, the default) vs jax's
    lax.scan transpose over the per-bounce VJP (=jax): the primal loss
    is BITWISE identical (same fused scan, incl. roulette + stats)
    and gradients agree to ulp-level accumulation noise (the roulette
    cond transpose and carry marshalling round differently)."""
    from rust_pathtracer_tpu.grad import (
        CameraParams,
        DiffParams,
        render_loss_and_grad,
    )
    from rust_pathtracer_tpu.render import RenderSettings

    sd = get_scene("CornellBox")
    scene = sd.build()
    cam = CameraParams.create(
        (278.0, 278.0, -800.0), (278.0, 278.0, 0.0), (0.0, 1.0, 0.0),
        40.0, 1.0, 0.0, 10.0,
    )
    settings = RenderSettings(16, 16, 4, 8, (0.5, 0.5, 0.5), spp_chunk=4,
                              differentiable=True,
                              russian_roulette_start=rr)
    params = DiffParams.from_scene(scene, cam, settings.background)
    target = jnp.zeros((16, 16, 3))
    _route(monkeypatch, True)
    monkeypatch.setenv("RPT_FBD_SCAN", "jax")
    l0, g0 = render_loss_and_grad(params, scene, settings, KEY, target)
    monkeypatch.setenv("RPT_FBD_SCAN", "vjp")
    jax.clear_caches()
    l1, g1 = render_loss_and_grad(params, scene, settings, KEY, target)
    assert float(l0) == float(l1)
    f0, _ = jax.flatten_util.ravel_pytree(g0)
    f1, _ = jax.flatten_util.ravel_pytree(g1)
    f0, f1 = np.asarray(f0), np.asarray(f1)
    assert np.abs(f0).max() > 0
    np.testing.assert_allclose(f1, f0, rtol=1e-4,
                               atol=1e-5 * np.abs(f0).max())

"""Gradient correctness: finite-difference checks (SURVEY §4c).

The renders are deterministic given a key, so central finite
differences on the same key measure exactly the derivative the
detached-sampling estimator defines (discrete decisions frozen).
"""

import dataclasses

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest

from rust_pathtracer_tpu.grad import (
    CameraParams,
    DiffParams,
    l2_loss,
    render_loss_and_grad,
    render_radiance_diff,
)
from rust_pathtracer_tpu.render import RenderSettings
from rust_pathtracer_tpu.scene.builder import SceneBuilder

KEY = jax.random.PRNGKey(0)


def _scene_simple():
    """Lambertian sphere + image-textured ground + rect light.

    The smooth (bilinear) ground texture matters for the CAMERA
    gradient tests: with solid colors only, radiance depends on camera
    parameters purely through *discrete* path structure, which the
    detached-sampling estimator freezes — its camera gradient is then
    legitimately zero.  A spatially continuous texture provides the
    reparameterized dependence hit-point -> texel -> radiance.
    """
    b = SceneBuilder()
    b.add_sphere((0.0, 0.5, -3.0), 0.5, b.lambertian((0.4, 0.5, 0.6)))  # tex 0
    ramp = np.linspace(0.1, 0.9, 8 * 8 * 3).reshape(8, 8, 3).astype(np.float32)
    ground_tex = b.image_texture(ramp)  # tex 1
    b.add_sphere((0.0, -100.0, -3.0), 100.0, b.lambertian(ground_tex))
    b.add_rect("xz", (-2.0, 4.0, -5.0), (2.0, 4.0, -1.0), -1.0, b.diffuse_light((5.0, 5.0, 5.0)))  # tex 2
    return b.build(use_bvh=False)


def _setup(width=12, height=12, spp=8, bounces=4):
    scene = _scene_simple()
    cam = CameraParams.create(
        (0.0, 1.0, 2.0), (0.0, 0.5, -3.0), (0.0, 1.0, 0.0), 50.0, 1.0
    )
    settings = RenderSettings(width, height, spp, bounces, (0.1, 0.1, 0.1))
    params = DiffParams.from_scene(scene, cam, settings.background)
    target = jnp.zeros((height, width, 3))
    return params, scene, settings, target


def _fd_check(params, scene, settings, target, get, replace, eps, rtol, atol=1e-7):
    """Central finite difference vs autodiff for one scalar slot."""
    loss, grads = render_loss_and_grad(params, scene, settings, KEY, target)
    g_auto = float(get(grads))

    def loss_at(x):
        return float(l2_loss(replace(params, x), scene, settings, KEY, target))

    x0 = float(get(params))
    g_fd = (loss_at(x0 + eps) - loss_at(x0 - eps)) / (2 * eps)
    assert np.isclose(g_auto, g_fd, rtol=rtol, atol=atol), (g_auto, g_fd)
    return g_auto


def _set_tex_color(params, idx, ch, val):
    return params._replace(tex_color=params.tex_color.at[idx, ch].set(val))


def test_albedo_gradient_fd():
    params, scene, settings, target = _setup()
    # texture 0 = sphere albedo, green channel
    g = _fd_check(
        params, scene, settings, target,
        get=lambda p: p.tex_color[0, 1],
        replace=lambda p, x: _set_tex_color(p, 0, 1, x),
        eps=1e-2, rtol=2e-2,
    )
    assert g != 0.0


def test_emission_gradient_fd():
    params, scene, settings, target = _setup()
    # texture 2 = light emission, red channel
    g = _fd_check(
        params, scene, settings, target,
        get=lambda p: p.tex_color[2, 0],
        replace=lambda p, x: _set_tex_color(p, 2, 0, x),
        eps=1e-2, rtol=2e-2,
    )
    assert g != 0.0


def test_background_gradient_fd():
    params, scene, settings, target = _setup()
    g = _fd_check(
        params, scene, settings, target,
        get=lambda p: p.background[2],
        replace=lambda p, x: p._replace(background=p.background.at[2].set(x)),
        eps=1e-2, rtol=2e-2,
    )
    assert g != 0.0


def _setup_camera_fd(width=10, height=10, spp=4):
    """Flip-free scene for CAMERA finite differences: one huge textured
    plane fills the whole view, scattered rays always escape to the
    background, so small camera perturbations change no discrete
    decision — FD then measures exactly the detached-sampling gradient
    (visibility discontinuities are out of scope by design)."""
    b = SceneBuilder()
    ramp = np.linspace(0.05, 0.95, 16 * 16 * 3).reshape(16, 16, 3).astype(np.float32)
    b.add_rect("xy", (-200.0, -200.0, -5.0), (200.0, 200.0, -5.0), 1.0,
               b.lambertian(b.image_texture(ramp)))
    scene = b.build(use_bvh=False)
    cam = CameraParams.create((0.0, 0.0, 0.0), (0.0, 0.0, -5.0), (0.0, 1.0, 0.0), 50.0, 1.0)
    settings = RenderSettings(width, height, spp, 2, (0.3, 0.3, 0.3))
    params = DiffParams.from_scene(scene, cam, settings.background)
    target = jnp.zeros((height, width, 3))
    return params, scene, settings, target


def test_camera_fov_gradient_fd():
    params, scene, settings, target = _setup_camera_fd()
    g = _fd_check(
        params, scene, settings, target,
        get=lambda p: p.camera.vfov_deg,
        replace=lambda p, x: p._replace(camera=p.camera._replace(vfov_deg=jnp.float32(x))),
        eps=1.0, rtol=7e-2, atol=1e-8,
    )
    assert g != 0.0


def test_camera_lookfrom_gradient_fd():
    params, scene, settings, target = _setup_camera_fd()
    g = _fd_check(
        params, scene, settings, target,
        get=lambda p: p.camera.lookfrom[1],
        replace=lambda p, x: p._replace(
            camera=p.camera._replace(lookfrom=p.camera.lookfrom.at[1].set(x))
        ),
        eps=0.05, rtol=7e-2, atol=1e-8,
    )
    assert g != 0.0


def test_texel_gradient_fd():
    # image-textured sphere: gradients reach individual texels
    b = SceneBuilder()
    img = jnp.full((4, 4, 3), 0.5)
    tex = b.image_texture(np.asarray(img))
    b.add_sphere((0.0, 0.0, -3.0), 1.0, b.lambertian(tex))
    scene = b.build(use_bvh=False)
    cam = CameraParams.create((0, 0, 0), (0, 0, -3), (0, 1, 0), 60.0, 1.0)
    settings = RenderSettings(8, 8, 8, 3, (1.0, 1.0, 1.0))
    params = DiffParams.from_scene(scene, cam, settings.background)
    target = jnp.zeros((8, 8, 3))

    loss, grads = render_loss_and_grad(params, scene, settings, KEY, target)
    g_img = np.asarray(grads.tex_images)
    assert np.abs(g_img).sum() > 0.0
    # FD on one texel that received gradient
    iy, ix, ch = np.unravel_index(np.abs(g_img[0]).argmax(), g_img[0].shape)
    eps = 1e-2

    def loss_at(x):
        p = params._replace(tex_images=params.tex_images.at[0, iy, ix, ch].set(x))
        return float(l2_loss(p, scene, settings, KEY, target))

    x0 = float(params.tex_images[0, iy, ix, ch])
    g_fd = (loss_at(x0 + eps) - loss_at(x0 - eps)) / (2 * eps)
    assert np.isclose(float(g_img[0, iy, ix, ch]), g_fd, rtol=3e-2, atol=1e-7)


def test_analytic_t_grads_match_rederive(monkeypatch):
    """RPT_DIFF_T=analytic replaces the differentiable re-intersection
    with the implicit-function linearization (integrator._analytic_t):
    the forward loss is bitwise the rederive-mode loss (the correction
    term is exactly zero in the primal), and every gradient — camera
    included, whose grads flow THROUGH the hit distance — matches the
    re-derived chain to fp-reassociation noise."""
    import jax.flatten_util

    for setup in (_setup, _setup_camera_fd):
        params, scene, settings, target = setup()
        results = {}
        for mode in ("rederive", "analytic"):
            monkeypatch.setenv("RPT_DIFF_T", mode)
            # env is read at trace time; same-shape second call would
            # reuse the jit cache (the vacuous-test trap of DESIGN §10)
            jax.clear_caches()
            loss, grads = render_loss_and_grad(
                params, scene, settings, KEY, target
            )
            results[mode] = (float(loss), grads)
        monkeypatch.delenv("RPT_DIFF_T")
        l0, g0 = results["rederive"]
        l1, g1 = results["analytic"]
        assert l0 == l1
        f0, _ = jax.flatten_util.ravel_pytree(g0)
        f1, _ = jax.flatten_util.ravel_pytree(g1)
        np.testing.assert_allclose(np.asarray(f0), np.asarray(f1),
                                   rtol=2e-3, atol=1e-6)
    jax.clear_caches()


def test_bf16_residual_contract():
    """remat="bf16" (ops/compressed_vjp.py): reverse-mode residuals
    stored in bfloat16.  The documented accuracy contract: the primal
    loss is BITWISE unchanged (only what is saved for the backward is
    rounded), and gradients stay within ~1e-2 normalized error of the
    f32-residual gradients.  The lower bound proves compression
    actually engaged (the render is sized above MIN_COMPRESS_ELEMS)."""
    import jax.flatten_util

    from rust_pathtracer_tpu.grad import render_loss_and_grad
    from rust_pathtracer_tpu.ops.compressed_vjp import MIN_COMPRESS_ELEMS

    params, scene, settings, target = _setup(
        width=64, height=64, spp=8, bounces=4
    )
    assert 64 * 64 * 8 >= MIN_COMPRESS_ELEMS
    l0, g0 = render_loss_and_grad(params, scene, settings, KEY, target)
    s16 = dataclasses.replace(settings, remat="bf16")
    l1, g1 = render_loss_and_grad(params, scene, s16, KEY, target)
    assert float(l0) == float(l1)
    f0, _ = jax.flatten_util.ravel_pytree(g0)
    f1, _ = jax.flatten_util.ravel_pytree(g1)
    rel = float(np.linalg.norm(np.asarray(f0) - np.asarray(f1))
                / np.linalg.norm(np.asarray(f0)))
    assert 1e-7 < rel < 1e-2, rel


def test_grads_finite_on_full_material_zoo():
    # metal + dielectric + lights + bvh: gradients exist and are finite
    b = SceneBuilder()
    b.add_sphere((0, -100.5, -3), 100.0, b.lambertian((0.5, 0.5, 0.5)))
    b.add_sphere((-1, 0, -3), 0.5, b.metal((0.8, 0.7, 0.6), 0.2))
    b.add_sphere((1, 0, -3), 0.5, b.dielectric(1.5))
    b.add_sphere((0, 0, -3), 0.5, b.lambertian((0.2, 0.4, 0.8)))
    b.add_rect("xz", (-2, 3, -5), (2, 3, -1), -1.0, b.diffuse_light((4, 4, 4)))
    scene = b.build(use_bvh=True, leaf_size=2)
    cam = CameraParams.create((0, 0.5, 1), (0, 0, -3), (0, 1, 0), 60.0, 1.0)
    settings = RenderSettings(8, 8, 4, 6, (0.2, 0.2, 0.2))
    params = DiffParams.from_scene(scene, cam, settings.background)
    loss, grads = render_loss_and_grad(
        params, scene, settings, KEY, jnp.zeros((8, 8, 3))
    )
    flat, _ = jax.flatten_util.ravel_pytree(grads)
    assert np.isfinite(np.asarray(flat)).all()
    assert float(jnp.abs(grads.tex_color).sum()) > 0


def test_gradient_descent_recovers_albedo():
    """End-to-end inverse rendering: recover a sphere's albedo."""
    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, -3.0), 1.0, b.lambertian((0.8, 0.3, 0.5)))
    scene = b.build(use_bvh=False)
    cam = CameraParams.create((0, 0, 0), (0, 0, -3), (0, 1, 0), 60.0, 1.0)
    settings = RenderSettings(12, 12, 8, 3, (1.0, 1.0, 1.0))
    params_true = DiffParams.from_scene(scene, cam, settings.background)
    target = render_radiance_diff(params_true, scene, settings, KEY)

    params = params_true._replace(
        tex_color=params_true.tex_color.at[0].set(jnp.asarray([0.5, 0.5, 0.5]))
    )
    grad_fn = jax.jit(
        lambda p: jax.value_and_grad(l2_loss)(p, scene, settings, KEY, target)
    )
    for i in range(150):
        loss, grads = grad_fn(params)
        # projected gradient step (albedo stays physical in [0, 1])
        params = params._replace(
            tex_color=jnp.clip(params.tex_color - 20.0 * grads.tex_color, 0.0, 1.0)
        )
    got = np.asarray(params.tex_color[0])
    assert np.allclose(got, [0.8, 0.3, 0.5], atol=0.03), got


def test_diff_search_kernel_matches_jnp():
    """Diff mode detaches the hit SEARCH, so its route must not matter:
    the same scene searched by the brute-force sweep and by the BVH
    gives the same radiance and gradients (idx/hit are exact between
    the two; t is re-derived either way)."""
    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, -3.0), 1.0, b.lambertian((0.8, 0.3, 0.5)))
    b.add_sphere((1.5, 0.2, -4.0), 0.8, b.metal((0.7, 0.7, 0.7), 0.1))
    b.add_rect("xz", (-5, -1, -8), (5, -1, 2), 1.0,
               b.lambertian((0.4, 0.5, 0.3)))
    scene_brute = b.build(use_bvh=False)
    scene_bvh = b.build(use_bvh=True)
    assert scene_bvh.bvh is not None and scene_brute.bvh is None
    cam = CameraParams.create((0, 0, 1), (0, 0, -3), (0, 1, 0), 50.0, 1.0)
    settings = RenderSettings(10, 10, 4, 3, (0.8, 0.8, 1.0))

    def run(scene):
        params = DiffParams.from_scene(scene, cam, settings.background)
        img = render_radiance_diff(params, scene, settings, KEY)
        loss, g = render_loss_and_grad(
            params, scene, settings, KEY, jnp.zeros((10, 10, 3))
        )
        return img, loss, g

    img_jnp, loss_jnp, g_jnp = run(scene_brute)
    img_k, loss_k, g_k = run(scene_bvh)
    np.testing.assert_allclose(np.asarray(img_jnp), np.asarray(img_k),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loss_jnp), float(loss_k), rtol=1e-6)
    fa, _ = jax.flatten_util.ravel_pytree(g_jnp)
    fb, _ = jax.flatten_util.ravel_pytree(g_k)
    np.testing.assert_allclose(np.asarray(fa), np.asarray(fb),
                               rtol=1e-4, atol=1e-6)


def test_remat_policies_match(monkeypatch):
    """RPT_REMAT none/mid/names trade residual storage for replay
    recompute (integrator.py trace).  RPT_REMAT is read at TRACE time,
    so each mode needs jax.clear_caches() — without it the jitted
    render reuses the first compilation and the comparison is vacuous
    (a same-shape call never re-reads the env).  The policies are
    mathematically identical but NOT bitwise (XLA fuses each variant
    differently): assert tight allclose, not equality."""
    params, scene, settings, target = _setup(spp=4, bounces=6)
    outs = {}
    for mode in ("none", "mid", "names"):
        monkeypatch.setenv("RPT_REMAT", mode)
        jax.clear_caches()
        loss, grads = render_loss_and_grad(params, scene, settings, KEY, target)
        flat, _ = jax.flatten_util.ravel_pytree(grads)
        outs[mode] = (float(loss), np.asarray(flat))
    monkeypatch.delenv("RPT_REMAT")
    jax.clear_caches()
    l0, g0 = outs["none"]
    assert np.isfinite(g0).all() and np.abs(g0).max() > 0
    for mode in ("mid", "names"):
        l, g = outs[mode]
        np.testing.assert_allclose(l, l0, rtol=1e-6)
        np.testing.assert_allclose(g, g0, rtol=1e-3, atol=1e-7)


def test_diff_cascade_matches_plain_scan(monkeypatch):
    """RPT_DIFF_CASCADE (static-width compaction inside the diff scan,
    integrator.py _trace_diff_cascade) must reproduce the plain
    fixed-length scan.  The env var is read at TRACE time, so the
    cascade run needs jax.clear_caches() — without it the second call
    is a cache hit of the plain compilation and the test is vacuous.
    The cascade also reports dropped-live lanes in occupancy[-1]
    (asserted zero here — and nonzero for an over-tight schedule)."""
    import dataclasses

    from rust_pathtracer_tpu.grad import apply_params
    from rust_pathtracer_tpu.render import render_radiance

    params, scene, settings, target = _setup(width=16, height=16, spp=4,
                                             bounces=12)

    def run():
        jax.clear_caches()
        loss, grads = render_loss_and_grad(params, scene, settings, KEY,
                                           target)
        flat, _ = jax.flatten_util.ravel_pytree(grads)
        s = apply_params(scene, params)
        _, stats = render_radiance(
            s, params.camera.build(),
            dataclasses.replace(settings, differentiable=True), KEY,
            background=params.background,
        )
        return float(loss), np.asarray(flat), float(stats.occupancy[-1])

    monkeypatch.delenv("RPT_DIFF_CASCADE", raising=False)
    loss0, g0, _ = run()
    monkeypatch.setenv("RPT_DIFF_CASCADE", "4:2,8:4")
    loss1, g1, overflow = run()
    monkeypatch.delenv("RPT_DIFF_CASCADE")
    jax.clear_caches()
    assert overflow == 0.0  # no live lane dropped by the slices
    np.testing.assert_allclose(loss1, loss0, rtol=1e-6)
    np.testing.assert_allclose(g1, g0, rtol=1e-3, atol=1e-7)

    # an over-tight schedule must REPORT dropped lanes, not silently
    # bias: boundary 1 at 1/16 width drops most of the live wavefront
    monkeypatch.setenv("RPT_DIFF_CASCADE", "1:16")
    jax.clear_caches()
    s2 = apply_params(scene, params)
    _, st2 = render_radiance(
        s2, params.camera.build(),
        dataclasses.replace(settings, differentiable=True), KEY,
        background=params.background,
    )
    monkeypatch.delenv("RPT_DIFF_CASCADE")
    jax.clear_caches()
    assert float(st2.occupancy[-1]) > 0


def test_remat_settings_field_forces_retrace():
    """RenderSettings.remat is a static jit argument: changing it must
    retrace WITHOUT jax.clear_caches() (unlike the RPT_REMAT env
    fallback, which a same-shape call never re-reads)."""
    import dataclasses

    params, scene, settings, target = _setup(spp=4, bounces=6)
    outs = {}
    for mode in (None, "mid", "names"):
        s = dataclasses.replace(settings, remat=mode)
        loss, grads = render_loss_and_grad(params, scene, s, KEY, target)
        flat, _ = jax.flatten_util.ravel_pytree(grads)
        outs[mode] = (float(loss), np.asarray(flat))
    l0, g0 = outs[None]
    for mode in ("mid", "names"):
        l, g = outs[mode]
        np.testing.assert_allclose(l, l0, rtol=1e-6)
        np.testing.assert_allclose(g, g0, rtol=1e-3, atol=1e-7)
    # the policies differ by f32 fusion rounding when actually traced
    # separately — byte-identical outputs would mean a vacuous cache hit
    assert not (np.array_equal(outs["mid"][1], g0)
                and np.array_equal(outs["names"][1], g0))


def test_rng_xs_matches(monkeypatch):
    """RPT_RNG_XS=1 hoists every per-bounce RNG draw out of the scan
    body into precomputed xs (integrator._precompute_draws).  The
    draws themselves are bitwise-identical (same threefry integer
    ops, vmapped over the bounce axis), so loss and gradients match
    the in-body path to fusion rounding.  Russian roulette is enabled
    so the precomputed roulette draw is covered too."""
    params, scene, settings, target = _setup(spp=4, bounces=6)
    settings = dataclasses.replace(settings, russian_roulette_start=3)
    loss0, g0 = render_loss_and_grad(params, scene, settings, KEY, target)
    f0, _ = jax.flatten_util.ravel_pytree(g0)
    monkeypatch.setenv("RPT_RNG_XS", "1")
    jax.clear_caches()
    loss1, g1 = render_loss_and_grad(params, scene, settings, KEY, target)
    f1, _ = jax.flatten_util.ravel_pytree(g1)
    monkeypatch.delenv("RPT_RNG_XS")
    jax.clear_caches()
    assert np.abs(np.asarray(f0)).max() > 0
    np.testing.assert_allclose(float(loss1), float(loss0), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(f1), np.asarray(f0),
                               rtol=1e-4, atol=1e-7)

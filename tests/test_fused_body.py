"""The fused bounce body, one bounce at a time.

ops/fused_bounce.bounce_body is the one implementation of the fused
bounce math, left to XLA on every backend.  Checked here on the four
fused benchmark scenes: the residual-writing bounce (forward of the
differentiable step) against the plain bounce, both against the
composed jnp path and the masked (R, P) sweep, and the custom VJP's
closed-form backward (``_bwd_xla`` + the texture contraction) against
finite differences and an explicit float64 sum.
"""

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest

from rust_pathtracer_tpu import sampling
from rust_pathtracer_tpu.integrator import T_MAX, T_MIN
from rust_pathtracer_tpu.models import get_scene
from rust_pathtracer_tpu.ops import fused_bounce as fb
from rust_pathtracer_tpu.scene.builder import SceneBuilder
from rust_pathtracer_tpu.scene.types import TEX_PERLIN

FUSED_SCENES = ("CornellBox", "TriangleTest", "LightTest",
                "TwoSphereCheckers")


def _state(scene_name, n, seed=0):
    """Camera lanes of a fused scene + one bounce's uniforms."""
    from rust_pathtracer_tpu.render import _make_lanes

    sd = get_scene(scene_name)
    scene = sd.build()
    side = int(np.ceil(np.sqrt(n)))
    pix = np.arange(n, dtype=np.uint32) % np.uint32(side * side)
    lk, o, d, _ = _make_lanes(sd.camera_at(0.0), jax.random.PRNGKey(seed),
                              pix, jnp.uint32(0), width=side, height=side,
                              spp_chunk=1, spp_total=1)
    return scene, sd.output.image.background, _cols(lk, o, d), lk


def _cols(lk, o, d):
    thr = 0.5 + 0.5 * sampling.uniform(sampling.bounce_keys(lk, 1, 0))
    ones = jnp.ones_like(thr)
    zeros = jnp.zeros_like(thr)
    return dict(zip(fb._COL_KEYS, (
        o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
        thr, thr * 0.8, thr * 0.6, zeros, zeros, zeros, ones,
    )))


def _uniforms(lk):
    su, bu, cn, _ = sampling.bounce_draws(lk, 0, False)
    return su[:, 0], su[:, 1], bu[:, 0], bu[:, 1], bu[:, 2], cn


def _bounce(scene, bg, cols, u, want_res):
    return fb._fused_bounce_cols(
        fb.pack_prims_shaded(scene), jnp.asarray(bg, jnp.float32),
        jnp.asarray(scene.textures.perlin_seed, jnp.uint32), cols, *u,
        kinds=scene.kinds_static, mat_types=scene.mat_types,
        tex_types=scene.tex_types, t_min=float(T_MIN),
        want_residuals=want_res,
    )


@pytest.mark.parametrize("lanes", [700, 1024])
@pytest.mark.parametrize("scene_name", FUSED_SCENES)
def test_residual_bounce_matches_plain_bounce(scene_name, lanes):
    """The residual-writing bounce (forward of the differentiable step)
    commits bitwise the plain bounce's state: the diff-mode image is
    the nondiff render's.  Every residual column is one value per
    lane."""
    scene, bg, cols, lk = _state(scene_name, lanes)
    assert fb.fused_bounce_ok(scene)
    u = _uniforms(lk)
    plain = _bounce(scene, bg, cols, u, False)
    out, res = _bounce(scene, bg, cols, u, True)
    assert set(res) == set(fb._RES_KEYS)
    for k in fb._RES_KEYS:
        assert res[k].shape == (lanes,), k
    flags = np.asarray(res["flags"])
    assert ((flags & fb.FLG_HIT) != 0).any()  # the camera sees the scene
    np.testing.assert_array_equal((flags & fb.FLG_CONT) != 0,
                                  np.asarray(out["al"]) > 0.5)
    for k in fb._COL_KEYS:
        assert out[k].shape == (lanes,), k
        np.testing.assert_array_equal(np.asarray(out[k]),
                                      np.asarray(plain[k]), err_msg=k)


@pytest.mark.parametrize("want_res", [False, True],
                         ids=["nondiff", "residuals"])
@pytest.mark.parametrize("scene_name", FUSED_SCENES)
def test_fused_body_matches_composed_step(monkeypatch, scene_name,
                                          want_res):
    """One fused bounce vs one composed-path bounce (_bounce_step with
    the scene routed off the fused bounce): alive mask exact, floats to
    fusion rounding (see below for perlin).  With residuals, the saved hit flags, winning
    indices and distances are the masked (R, P) sweep's."""
    from rust_pathtracer_tpu.integrator import MAX_BOUNCE_STATS, _bounce_step
    from rust_pathtracer_tpu.ops.intersect import closest_hit_brute

    scene, bg, cols, lk = _state(scene_name, 900, seed=2)
    out = _bounce(scene, bg, cols, _uniforms(lk), want_res)
    if want_res:
        out, res = out

    def stack(pre):
        return jnp.stack([cols[f"{pre}{c}"] for c in "012"], 1)

    o, d = stack("o"), stack("d")
    state = dict(o=o, d=d, thr=stack("t"), rad=stack("r"),
                 alive=cols["al"] > 0.5, segments=jnp.float32(0.0),
                 occupancy=jnp.zeros((MAX_BOUNCE_STATS,), jnp.float32))
    monkeypatch.setattr(fb, "fused_bounce_ok", lambda s: False)
    ref = _bounce_step(scene, lk, jnp.asarray(bg, jnp.float32), 99, state,
                       jnp.int32(0))
    np.testing.assert_array_equal(np.asarray(out["al"]) > 0.5,
                                  np.asarray(ref["alive"]))
    # perlin marble's sin(10 * turbulence) amplifies a hit-point ulp to
    # ~1e-2 relative on a few lanes; every other float is tight
    off_limit = 0.01 if TEX_PERLIN in scene.tex_types else 0.0
    for key, pre in (("o", "o"), ("d", "d"), ("thr", "t"), ("rad", "r")):
        got = np.stack([np.asarray(out[f"{pre}{c}"]) for c in "012"], 1)
        want = np.asarray(ref[key])
        off = ~np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=1)
        assert off.mean() <= off_limit, (key, off.mean())
    if want_res:
        hit, t, idx = closest_hit_brute(scene.prims, o, d, T_MIN, T_MAX,
                                        prim_types=scene.prim_types)
        flags = np.asarray(res["flags"])
        hm = np.asarray(hit)
        np.testing.assert_array_equal((flags & fb.FLG_HIT) != 0, hm)
        np.testing.assert_array_equal(
            (flags >> fb.FLG_BESTI_SHIFT)[hm], np.asarray(idx)[hm])
        np.testing.assert_allclose(np.asarray(res["t"])[hm],
                                   np.asarray(t)[hm], rtol=1e-5, atol=1e-3)


def _checker_scene():
    """Fused-diff scene whose texture gradient lands on all three
    packed colour groups (solid, checker odd, checker even)."""
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
    return b.build(use_bvh=False)


def _diff_state(name, n, seed):
    if name != "checker":
        return _state(name, n, seed)
    scene = _checker_scene()
    ang = jnp.linspace(-0.5, 0.5, n)
    o = jnp.tile(jnp.asarray([[0.0, 0.8, 1.5]]), (n, 1))
    d = jnp.stack(
        [jnp.sin(ang), 0.3 * jnp.cos(5 * ang) - 0.3, -jnp.cos(ang)], axis=1
    )
    lk = sampling.lane_keys(jax.random.PRNGKey(seed),
                            jnp.arange(n, dtype=jnp.uint32))
    return scene, (0.1, 0.2, 0.3), _cols(lk, o, d), lk


def _weights(shape):
    k = jax.random.PRNGKey(3)
    return {c: jax.random.normal(jax.random.fold_in(k, i), shape)
            for i, c in enumerate(fb._COL_KEYS[:12])}


def _vjp_loss(scene, u, ws):
    bounce = fb._make_fused_bounce_vjp(
        scene.kinds_static, scene.mat_types, scene.tex_types, float(T_MIN),
    )

    def loss(cols_, packed_, bg_):
        out = bounce(cols_, *u, packed_, bg_)
        return sum(jnp.sum(ws[c] * out[c]) for c in ws)

    return loss


DIFF_SCENES = ("CornellBox", "TriangleTest", "checker")


@pytest.mark.parametrize("scene_name", DIFF_SCENES)
def test_custom_vjp_texture_contraction_is_exact(scene_name):
    """The texture-colour gradient is a one-hot contraction at HIGHEST
    precision: each packed colour group (solid, checker odd, checker
    even) equals an explicit per-primitive float64 sum of the same
    per-lane terms."""
    scene, bg, cols, lk = _diff_state(scene_name, 700, seed=6)
    assert fb.fused_bounce_diff_ok(scene)
    u = _uniforms(lk)
    ws = _weights(cols["o0"].shape)
    packed = fb.pack_prims_shaded(scene)
    bg = jnp.asarray(bg, jnp.float32) + 0.25
    g_packed = jax.grad(_vjp_loss(scene, u, ws), argnums=1)(cols, packed, bg)
    _out, res = _bounce(scene, bg, cols, u, True)
    flags = np.asarray(res["flags"])
    hit = (flags & fb.FLG_HIT) != 0
    cont = (flags & fb.FLG_CONT) != 0
    lm = ((flags & (fb.FLG_SEL_L | fb.FLG_SEL_M)) != 0) & cont
    on = (flags & fb.FLG_LIGHT_ON) != 0
    ck = (flags & fb.FLG_IS_CK) != 0
    neg = (flags & fb.FLG_SINES_NEG) != 0
    best = flags >> fb.FLG_BESTI_SHIFT
    groups = ((fb.PAY_COLOR, hit & ~ck), (fb.PAY_ODD, ck & neg),
              (fb.PAY_EVEN, ck & ~neg))
    expect = np.zeros(np.asarray(packed).shape, np.float64)
    for c in range(3):
        thr = np.asarray(cols[f"t{c}"], np.float64)
        w_t = np.asarray(ws[f"t{c}"], np.float64)
        w_r = np.asarray(ws[f"r{c}"], np.float64)
        g = lm * thr * w_t + on * thr * w_r
        for row, mask in groups:
            np.add.at(expect[row + c], best, g * (hit & mask))
    used = [row + c for row, mask in groups if mask.any() for c in range(3)]
    if scene_name == "checker":
        assert len(used) == 9  # every colour group is exercised
    assert np.abs(expect[used]).max() > 0
    np.testing.assert_allclose(np.asarray(g_packed)[used], expect[used],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scene_name", DIFF_SCENES)
def test_custom_vjp_matches_finite_differences(scene_name):
    """The closed-form backward vs central finite differences of the
    fused forward itself (same frozen discrete decisions), on the
    largest gradient entries of the state columns, the packed table
    and the background.  An entry whose difference quotient changes
    with the step sits on a discrete edge (a checker boundary, a
    grazing hit) where the detached estimator defines no derivative,
    and is skipped."""
    scene, bg, cols, lk = _diff_state(scene_name, 96, seed=5)
    u = _uniforms(lk)
    ws = _weights(cols["o0"].shape)
    loss = _vjp_loss(scene, u, ws)
    args = (cols, fb.pack_prims_shaded(scene),
            jnp.asarray(bg, jnp.float32) + 0.25)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    flat_args, unravel = jax.flatten_util.ravel_pytree(args)
    flat_g, _ = jax.flatten_util.ravel_pytree(grads)
    x0 = np.asarray(flat_args, np.float64)
    g = np.asarray(flat_g)

    def fd(i, eps):
        xp, xm = x0.copy(), x0.copy()
        xp[i] += eps
        xm[i] -= eps
        return (float(loss(*unravel(jnp.asarray(xp, jnp.float32))))
                - float(loss(*unravel(jnp.asarray(xm, jnp.float32))))
                ) / (2 * eps)

    checked = skipped = 0
    for i in np.argsort(-np.abs(g))[:40]:
        if abs(g[i]) <= 1e-3:
            break
        eps = max(1e-3 * abs(x0[i]), 1e-4)
        fd1, fd2 = fd(i, eps), fd(i, eps / 2)
        if not np.isclose(fd1, fd2, rtol=0.02, atol=1e-3):
            skipped += 1
            continue
        assert np.isclose(g[i], fd2, rtol=0.05, atol=1e-3), (i, g[i], fd2)
        checked += 1
    assert checked >= 24 and skipped <= 4, (checked, skipped)

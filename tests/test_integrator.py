import jax
import jax.numpy as jnp
import numpy as np

from rust_pathtracer_tpu import sampling
from rust_pathtracer_tpu.camera import make_camera
from rust_pathtracer_tpu.integrator import trace
from rust_pathtracer_tpu.render import RenderSettings, render_radiance
from rust_pathtracer_tpu.scene.builder import SceneBuilder


def _lane_keys(n, seed=0):
    return sampling.lane_keys(jax.random.PRNGKey(seed), jnp.arange(n, dtype=jnp.uint32))


def _simple_scene():
    b = SceneBuilder()
    b.add_sphere((0, 0, -5), 1.0, b.lambertian((0.5, 0.5, 0.5)))
    return b.build(use_bvh=False)


def test_zero_bounces_is_black():
    # ray.rs:21-23: bounces_left == 0 -> black, even on a guaranteed hit
    scene = _simple_scene()
    o = jnp.zeros((4, 3))
    d = jnp.asarray([[0.0, 0.0, -1.0]] * 4)
    rad, stats = trace(scene, o, d, _lane_keys(4), (1.0, 1.0, 1.0), max_bounces=0)
    assert np.allclose(np.asarray(rad), 0.0)
    assert float(stats.segments) == 0.0


def test_miss_returns_background_exactly():
    scene = _simple_scene()
    o = jnp.zeros((4, 3))
    d = jnp.asarray([[0.0, 1.0, 0.0]] * 4)  # miss
    rad, _ = trace(scene, o, d, _lane_keys(4), (0.2, 0.4, 0.6), max_bounces=5)
    assert np.allclose(np.asarray(rad), [0.2, 0.4, 0.6], atol=1e-6)


def test_direct_light_emission_value():
    b = SceneBuilder()
    b.add_rect("xy", (-1, -1, -3), (1, 1, -3), 1.0, b.diffuse_light((7, 7, 7)))
    scene = b.build(use_bvh=False)
    o = jnp.zeros((2, 3))
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0]])
    rad, _ = trace(scene, o, d, _lane_keys(2), (0.0, 0.0, 0.0), max_bounces=3)
    assert np.allclose(np.asarray(rad[0]), [7, 7, 7], atol=1e-5)  # sees light
    assert np.allclose(np.asarray(rad[1]), [0, 0, 0])  # misses, black bg


def test_light_path_dies_after_emission():
    # a light hit terminates the path: segments == 1 per lane
    b = SceneBuilder()
    b.add_rect("xy", (-9, -9, -3), (9, 9, -3), 1.0, b.diffuse_light((7, 7, 7)))
    scene = b.build(use_bvh=False)
    o = jnp.zeros((8, 3))
    d = jnp.asarray([[0.0, 0.0, -1.0]] * 8)
    _, stats = trace(scene, o, d, _lane_keys(8), (0.0, 0.0, 0.0), max_bounces=50)
    assert float(stats.segments) == 8.0
    assert int(stats.bounces) == 1  # early exit: all lanes dead


def test_furnace_throughput_products():
    # lambertian albedo a, white background: with all paths escaping
    # after k hits, E[radiance] = E[a^k]; single plane below -> exactly
    # one bounce for rays pointed at it, so radiance = a * 1.
    b = SceneBuilder()
    b.add_rect("xz", (-50, 0, -50), (50, 0, 50), 1.0, b.lambertian((0.25, 0.5, 0.75)))
    scene = b.build(use_bvh=False)
    n = 2000
    o = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (n, 1))
    d = jnp.asarray(np.tile([[0.1, -1.0, 0.05]], (n, 1)), jnp.float32)
    rad, _ = trace(scene, o, d, _lane_keys(n), (1.0, 1.0, 1.0), max_bounces=10)
    mean = np.asarray(rad).mean(0)
    # ~absorbed at second hit? plane is one-sided-infinite: scattered
    # hemisphere rays all escape upward -> exactly one attenuation.
    assert np.allclose(mean, [0.25, 0.5, 0.75], atol=0.02)


def test_max_bounces_cap_matches_reference_count():
    # two parallel mirrors: ray bounces forever; with max_bounces=B the
    # wavefront must execute exactly B iterations then stop
    b = SceneBuilder()
    m = b.metal((1.0, 1.0, 1.0), 0.0)
    b.add_rect("xy", (-1, -1, 0), (1, 1, 0), 1.0, m)
    b.add_rect("xy", (-1, -1, 2), (1, 1, 2), -1.0, m)
    scene = b.build(use_bvh=False)
    o = jnp.asarray([[0.0, 0.0, 1.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    rad, stats = trace(scene, o, d, _lane_keys(1), (1.0, 1.0, 1.0), max_bounces=7)
    assert int(stats.bounces) == 7
    assert float(stats.segments) == 7.0
    assert np.allclose(np.asarray(rad), 0.0)  # never escaped -> black


def test_render_orientation_top_row_is_high_y():
    # emissive rect high up, black elsewhere: top image rows brighter
    b = SceneBuilder()
    b.add_rect("xy", (-10, 2, -5), (10, 10, -5), 1.0, b.diffuse_light((5, 5, 5)))
    b.add_rect("xy", (-10, -10, -5), (10, -2, -5), 1.0, b.lambertian((0.0, 0.0, 0.0)))
    scene = b.build(use_bvh=False)
    cam = make_camera((0, 0, 5), (0, 0, 0), (0, 1, 0), 60.0, 1.0)
    s = RenderSettings(16, 16, 4, 3, (0.0, 0.0, 0.0))
    img, _ = render_radiance(scene, cam, s, jax.random.PRNGKey(0))
    img = np.asarray(img)
    assert img[:4].mean() > img[-4:].mean() + 0.5


def test_russian_roulette_unbiased():
    # RR keeps the estimator's mean (within noise) while killing lanes
    b = SceneBuilder()
    b.add_rect("xz", (-50, 0, -50), (50, 0, 50), 1.0, b.lambertian((0.8, 0.8, 0.8)))
    b.add_rect("xz", (-50, 4, -50), (50, 4, 50), -1.0, b.lambertian((0.8, 0.8, 0.8)))
    scene = b.build(use_bvh=False)
    n = 6000
    o = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (n, 1))
    d = jnp.asarray(np.tile([[0.3, -1.0, 0.1]], (n, 1)), jnp.float32)
    r1, s1 = trace(scene, o, d, _lane_keys(n, 1), (1.0, 1.0, 1.0), max_bounces=40)
    r2, s2 = trace(
        scene, o, d, _lane_keys(n, 2), (1.0, 1.0, 1.0), max_bounces=40,
        russian_roulette_start=3,
    )
    m1, m2 = float(np.asarray(r1).mean()), float(np.asarray(r2).mean())
    assert abs(m1 - m2) / m1 < 0.05
    assert float(s2.segments) < float(s1.segments)  # RR saved work


def _cluster_scene(n=600, seed=44, use_bvh=False):
    """A scene well past the static-sweep size (BVH territory)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    mats = [
        b.lambertian((0.6, 0.3, 0.3)),
        b.metal((0.8, 0.8, 0.8), 0.2),
        b.dielectric(1.5),
        b.diffuse_light((4.0, 4.0, 4.0)),
    ]
    for i in range(n):
        b.add_sphere(rng.uniform(-12, 12, 3), rng.uniform(0.3, 0.9),
                     mats[int(rng.integers(len(mats)))])
    return b.build(use_bvh=use_bvh)


def test_wavefront_reorder_equivalence():
    """Permuting the wavefront's lanes must not change the estimator:
    each lane carries its own RNG key, so tracing a sorted copy of the
    lanes (integrator.sort_carry, the permutation the cascade applies
    at its boundaries) and sorting back gives every lane's radiance
    bitwise — here through the BVH search."""
    from rust_pathtracer_tpu.integrator import sort_carry

    scene = _cluster_scene(use_bvh=True)
    assert scene.bvh is not None
    n = 2048
    rng = np.random.default_rng(9)
    o = jnp.asarray(rng.uniform(-14, 14, (n, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    keys = _lane_keys(n, seed=3)
    rad0, st0 = trace(scene, o, d, keys, (0.7, 0.8, 1.0), max_bounces=6)

    octant = ((d[:, 0] < 0).astype(jnp.int32) * 4
              + (d[:, 1] < 0).astype(jnp.int32) * 2
              + (d[:, 2] < 0).astype(jnp.int32))
    lane = jnp.arange(n, dtype=jnp.int32)
    o_s, d_s, k_s, lane_s = sort_carry((octant,), [o, d, keys, lane])
    assert not np.array_equal(np.asarray(lane_s), np.arange(n))
    rad1, st1 = trace(scene, o_s, d_s, k_s, (0.7, 0.8, 1.0), max_bounces=6)
    back = np.empty_like(np.asarray(rad1))
    back[np.asarray(lane_s)] = np.asarray(rad1)

    assert float(st0.segments) == float(st1.segments)
    r0 = np.asarray(rad0)
    close = np.all(np.isclose(r0, back, rtol=1e-5, atol=1e-6), axis=-1)
    assert close.mean() > 0.995, close.mean()
    np.testing.assert_allclose(r0.mean(axis=0), back.mean(axis=0), rtol=1e-4)


def test_wavefront_reorder_auto_routing():
    """Search routing by scene size: small scenes carry the static kind
    table (fused-bounce eligible where the route exists), large ones a
    BVH; the BVH search equals the brute-force sweep on the same rays."""
    from rust_pathtracer_tpu.ops.intersect import closest_hit, closest_hit_brute

    big = _cluster_scene(600, use_bvh=True)
    small = _cluster_scene(40)
    assert big.kinds_static is None and big.bvh is not None
    assert small.kinds_static is not None and small.bvh is None
    n = 512
    rng = np.random.default_rng(2)
    o = jnp.asarray(rng.uniform(-14, 14, (n, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    h1, t1, i1 = closest_hit(big, o, d, 1e-3, 1e30)
    h2, t2, i2 = closest_hit_brute(big.prims, o, d, 1e-3, 1e30,
                                   prim_types=big.prim_types)
    assert np.array_equal(np.asarray(h1), np.asarray(h2))
    hm = np.asarray(h1)
    assert np.array_equal(np.asarray(i1)[hm], np.asarray(i2)[hm])
    # the BVH leaf tests and the (R, P) sweep compile separately: t
    # agrees to a few ulp of the sphere quadratic's cancellation
    np.testing.assert_allclose(np.asarray(t1)[hm], np.asarray(t2)[hm],
                               rtol=1e-4)


def test_rng_xs_nondiff_matches(monkeypatch):
    """RPT_RNG_XS=1 on the nondiff while_loop path: per-bounce draws
    come from a dynamic slice of the precomputed (B, R, ...) arrays —
    radiance must match the in-body path to fusion rounding (the draw
    values themselves are bitwise-identical)."""
    b = SceneBuilder()
    b.add_sphere((0, 0, -5), 1.0, b.lambertian((0.6, 0.5, 0.4)))
    b.add_sphere((2, 0, -5), 1.0, b.metal((0.8, 0.8, 0.8), fuzz=0.3))
    b.add_sphere((-2, 0, -5), 1.0, b.dielectric(1.5))
    b.add_rect("xz", (-4, 4, -8), (4, 4, -2), -1.0, b.diffuse_light((4, 4, 4)))
    scene = b.build(use_bvh=False)
    n = 64
    ang = jnp.linspace(-0.4, 0.4, n)
    o = jnp.zeros((n, 3))
    d = jnp.stack([jnp.sin(ang), 0.1 * jnp.cos(7 * ang), -jnp.cos(ang)], axis=1)
    keys = _lane_keys(n)
    rad0, st0 = trace(scene, o, d, keys, (0.1, 0.2, 0.3), max_bounces=8,
                      russian_roulette_start=3)
    monkeypatch.setenv("RPT_RNG_XS", "1")
    jax.clear_caches()
    rad1, st1 = trace(scene, o, d, keys, (0.1, 0.2, 0.3), max_bounces=8,
                      russian_roulette_start=3)
    monkeypatch.delenv("RPT_RNG_XS")
    jax.clear_caches()
    np.testing.assert_allclose(np.asarray(rad1), np.asarray(rad0),
                               rtol=1e-5, atol=1e-6)
    assert float(st1.segments) == float(st0.segments)

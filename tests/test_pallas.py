"""Unrolled static-kind sweep vs the masked (R, P) jnp sweep.

The static sweep (ops/fused_bounce.static_sweep, exposed for search as
ops/intersect.closest_hit_static) is the fused bounce's own search: one
statically typed test per primitive.  Contract vs the masked sweep:
hit masks and winning indices identical, t to a few ulp.
"""

import jax.numpy as jnp
import numpy as np

from rust_pathtracer_tpu.models import get_scene
from rust_pathtracer_tpu.ops.intersect import (
    closest_hit_brute,
    closest_hit_static,
)
from rust_pathtracer_tpu.scene.builder import SceneBuilder


def _compare(scene, o, d):
    h1, t1, i1 = closest_hit_brute(
        scene.prims, o, d, 1e-3, 1e30, prim_types=scene.prim_types
    )
    h2, t2, i2 = closest_hit_static(scene, o, d, 1e-3)
    assert np.array_equal(np.asarray(h1), np.asarray(h2))
    hm = np.asarray(h1)
    assert np.allclose(np.asarray(t1)[hm], np.asarray(t2)[hm], rtol=1e-5, atol=1e-3)
    assert np.array_equal(np.asarray(i1)[hm], np.asarray(i2)[hm])


def test_pallas_matches_jnp_cornell():
    scene = get_scene("CornellBox").build()
    assert scene.kinds_static is not None
    rng = np.random.default_rng(0)
    R = 1500
    o = jnp.asarray(rng.uniform(0, 555, (R, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(R, 3)), jnp.float32)
    _compare(scene, o, d)


def test_pallas_matches_jnp_mixed_types():
    b = SceneBuilder()
    m = b.lambertian((0.5, 0.5, 0.5))
    rng = np.random.default_rng(1)
    for _ in range(10):
        b.add_sphere(rng.uniform(-5, 5, 3), rng.uniform(0.3, 1.2), m)
    for _ in range(8):
        p = rng.uniform(-5, 5, 3)
        b.add_triangle(p, p + rng.uniform(-2, 2, 3), p + rng.uniform(-2, 2, 3), m)
    for plane, fixed in [("xy", 2), ("xz", 1), ("yz", 0)]:
        s = rng.uniform(-5, 5, 3)
        e = s + rng.uniform(1, 3, 3)
        e[fixed] = s[fixed]
        b.add_rect(plane, s, e, 1.0, m)
    scene = b.build(use_bvh=False)
    o = jnp.asarray(rng.uniform(-7, 7, (700, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(700, 3)), jnp.float32)
    _compare(scene, o, d)


def test_mid_size_scene_carries_projected_tables():
    # SphereField (514 prims) is past the static-sweep size: it carries
    # a BVH for the search and no static kind table (so the fused
    # bounce never routes it)
    from rust_pathtracer_tpu.ops.fused_bounce import fused_bounce_ok
    from rust_pathtracer_tpu.ops.intersect import MAX_STATIC_PRIMS

    scene = get_scene("SphereField").build()
    assert scene.num_prims > MAX_STATIC_PRIMS
    assert scene.bvh is not None
    assert scene.kinds_static is None
    assert not fused_bounce_ok(scene)
    assert not hasattr(scene, "proj")


def test_fused_record_kernel_matches_hit_record():
    """The static sweep's winner record (outward normal, material id via
    the packed shading table) agrees with the composed hit_record."""
    from rust_pathtracer_tpu.ops.fused_bounce import (
        pack_prims_shaded,
        static_sweep,
    )
    from rust_pathtracer_tpu.ops.intersect import hit_record

    scene = get_scene("CornellBox").build()
    rng = np.random.default_rng(5)
    R = 1500
    o = jnp.asarray(rng.uniform(0, 555, (R, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(R, 3)), jnp.float32)
    h1, t1, i1 = closest_hit_brute(
        scene.prims, o, d, 1e-3, 1e30, prim_types=scene.prim_types
    )
    rec1 = hit_record(scene.prims, i1, o, d, jnp.where(h1, t1, 1.0), h1,
                      scene.prim_types)
    packed = pack_prims_shaded(scene)
    best_t, best_i, n_out, _invr, (mat,) = static_sweep(
        scene.kinds_static, lambda row, p: packed[row, p],
        (o[:, 0], o[:, 1], o[:, 2]), (d[:, 0], d[:, 1], d[:, 2]), 1e-3,
        shade_rows=(14,),
    )
    hm = np.asarray(h1)
    assert np.array_equal(hm, np.asarray(best_i) >= 0)
    assert np.array_equal(np.asarray(i1)[hm], np.asarray(best_i)[hm])
    n_out = np.stack([np.asarray(c) for c in n_out], 1)
    front = np.sum(np.asarray(d) * n_out, axis=1) < 0.0
    normal = np.where(front[:, None], n_out, -n_out)
    assert np.allclose(np.asarray(rec1.normal)[hm], normal[hm], atol=2e-5)
    assert np.array_equal(np.asarray(rec1.front_face)[hm], front[hm])
    assert np.array_equal(np.asarray(rec1.mat)[hm],
                          np.round(np.asarray(mat)[hm]).astype(np.int32))


def test_closest_hit_routes_static_sweep_with_a_fused_route(monkeypatch):
    """Small static scenes search with the static sweep on every
    backend; hits and indices are the masked sweep's."""
    from rust_pathtracer_tpu.ops import intersect

    scene = get_scene("CornellBox").build()
    rng = np.random.default_rng(3)
    o = jnp.asarray(rng.uniform(0, 555, (600, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(600, 3)), jnp.float32)
    called = []
    real = intersect.closest_hit_static

    def spy(*a, **k):
        called.append(1)
        return real(*a, **k)

    monkeypatch.setattr(intersect, "closest_hit_static", spy)
    h0, _t0, i0 = closest_hit_brute(scene.prims, o, d, 1e-3, 1e30,
                                    prim_types=scene.prim_types)
    h1, _t1, i1 = intersect.closest_hit(scene, o, d, 1e-3, 1e30)
    assert called
    assert np.array_equal(np.asarray(h0), np.asarray(h1))
    hm = np.asarray(h0)
    assert np.array_equal(np.asarray(i0)[hm], np.asarray(i1)[hm])

import jax.numpy as jnp
import numpy as np

from rust_pathtracer_tpu.ops.intersect import (
    T_MISS,
    aabb_hit,
    closest_hit_brute,
    hit_record,
    prim_intersect_t,
    rect_t,
    sphere_t,
    triangle_t,
)
from rust_pathtracer_tpu.scene.builder import SceneBuilder

INF = 1e30


def _rays(o, d):
    return jnp.asarray([o], jnp.float32), jnp.asarray([d], jnp.float32)


def _sphere_data(c, r):
    d = np.zeros(12, np.float32)
    d[0:3] = c
    d[3] = r
    return jnp.asarray([d])


def test_sphere_hit_nearest_root():
    o, d = _rays((0, 0, 0), (0, 0, -1))
    t, valid = sphere_t(_sphere_data((0, 0, -5), 1.0), o, d, 1e-3, INF)
    assert bool(valid[0]) and np.isclose(float(t[0]), 4.0, atol=1e-5)


def test_sphere_inside_second_root():
    # origin inside sphere: nearest root negative -> far root taken
    o, d = _rays((0, 0, -5), (0, 0, -1))
    t, valid = sphere_t(_sphere_data((0, 0, -5), 1.0), o, d, 1e-3, INF)
    assert bool(valid[0]) and np.isclose(float(t[0]), 1.0, atol=1e-5)


def test_sphere_unnormalized_direction_scales_t():
    o, d = _rays((0, 0, 0), (0, 0, -2))
    t, valid = sphere_t(_sphere_data((0, 0, -5), 1.0), o, d, 1e-3, INF)
    assert np.isclose(float(t[0]), 2.0, atol=1e-5)  # t in units of |d|


def test_sphere_miss():
    o, d = _rays((0, 0, 0), (0, 1, 0))
    t, valid = sphere_t(_sphere_data((0, 0, -5), 1.0), o, d, 1e-3, INF)
    assert not bool(valid[0]) and float(t[0]) == float(T_MISS)


def test_negative_radius_normal_flips():
    b = SceneBuilder()
    m = b.lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0, 0, -5), -1.0, m)
    scene = b.build(use_bvh=False)
    o = jnp.asarray([[0.0, 0.0, 0.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    hit, t, idx = closest_hit_brute(scene.prims, o, d, 1e-3, INF)
    rec = hit_record(scene.prims, idx, o, d, t, hit)
    # outward normal = (p-c)/r with r<0 points INTO the sphere (+z hit
    # point gives -z outward), the ray travels -z so dot(d, outward) > 0
    # -> front_face False (geometry.rs:29-37 + negative radius quirk)
    assert bool(hit[0])
    assert not bool(rec.front_face[0])
    assert np.allclose(np.asarray(rec.normal[0]), [0, 0, 1], atol=1e-5)


def test_rect_xz_hit_uv_and_normal():
    b = SceneBuilder()
    m = b.lambertian((1, 1, 1))
    b.add_rect("xz", (1.0, 2.0, 3.0), (5.0, 2.0, 7.0), -1.0, m)
    scene = b.build(use_bvh=False)
    o = jnp.asarray([[2.0, 5.0, 4.0]])
    d = jnp.asarray([[0.0, -1.0, 0.0]])
    hit, t, idx = closest_hit_brute(scene.prims, o, d, 1e-3, INF)
    rec = hit_record(scene.prims, idx, o, d, t, hit)
    assert bool(hit[0]) and np.isclose(float(t[0]), 3.0)
    # u from x: (2-1)/4, v from z: (4-3)/4 (geometry.rs:288-296)
    assert np.isclose(float(rec.u[0]), 0.25, atol=1e-6)
    assert np.isclose(float(rec.v[0]), 0.25, atol=1e-6)
    # direction -1 -> outward (0,-1,0); ray goes -y -> dot<0? d.(0,-1,0)=1>0
    # -> front_face False, normal flipped to (0,1,0)
    assert not bool(rec.front_face[0])
    assert np.allclose(np.asarray(rec.normal[0]), [0, 1, 0])


def test_rect_parallel_ray_misses():
    b = SceneBuilder()
    m = b.lambertian((1, 1, 1))
    b.add_rect("xy", (0, 0, 0), (1, 1, 0), 1.0, m)
    scene = b.build(use_bvh=False)
    o = jnp.asarray([[0.5, 0.5, 0.0]])  # in the plane
    d = jnp.asarray([[1.0, 0.0, 0.0]])  # parallel
    t, valid = rect_t(scene.prims.data, scene.prims.aux, o, d, 1e-3, INF)
    assert not bool(valid[0])


def test_triangle_one_sided_cull():
    b = SceneBuilder()
    m = b.lambertian((1, 1, 1))
    # CCW when viewed from +z: edges (p2-p1)x(p3-p1) = +z normal
    b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), m)
    scene = b.build(use_bvh=False)
    # Moller-Trumbore det = dot(e1, d x e2) = -d.n with n = e1 x e2:
    # rays TRAVELLING AGAINST the geometric normal hit (det > eps);
    # rays along the normal are culled (geometry.rs:526)
    o1 = jnp.asarray([[0.2, 0.2, 1.0]])
    d1 = jnp.asarray([[0.0, 0.0, -1.0]])
    t1, v1 = triangle_t(scene.prims.data, o1, d1, 1e-3, INF)
    o2 = jnp.asarray([[0.2, 0.2, -1.0]])
    d2 = jnp.asarray([[0.0, 0.0, 1.0]])
    _, v2 = triangle_t(scene.prims.data, o2, d2, 1e-3, INF)
    assert bool(v1[0]) and np.isclose(float(t1[0]), 1.0, atol=1e-5)
    assert not bool(v2[0])


def test_triangle_uv_reported_zero():
    b = SceneBuilder()
    m = b.lambertian((1, 1, 1))
    b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), m)
    scene = b.build(use_bvh=False)
    o = jnp.asarray([[0.2, 0.3, 1.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    hit, t, idx = closest_hit_brute(scene.prims, o, d, 1e-3, INF)
    rec = hit_record(scene.prims, idx, o, d, t, hit)
    assert bool(hit[0])
    assert float(rec.u[0]) == 0.0 and float(rec.v[0]) == 0.0  # geometry.rs:553-556


def test_aabb_slab():
    bmin = jnp.asarray([[0.0, 0.0, 0.0]])
    bmax = jnp.asarray([[1.0, 1.0, 1.0]])
    o = jnp.asarray([[0.5, 0.5, -2.0]])
    hit_d = jnp.asarray([[0.0, 0.0, 1.0]])
    miss_d = jnp.asarray([[0.0, 1.0, 0.001]])
    assert bool(aabb_hit(bmin, bmax, o, 1.0 / hit_d, 1e-3, INF)[0])
    assert not bool(aabb_hit(bmin, bmax, o, 1.0 / miss_d, 1e-3, INF)[0])
    # negative direction component (swap branch, bvh.rs:26-28)
    o2 = jnp.asarray([[0.5, 0.5, 2.0]])
    d2 = jnp.asarray([[0.0, 0.0, -1.0]])
    assert bool(aabb_hit(bmin, bmax, o2, 1.0 / d2, 1e-3, INF)[0])


def test_closest_hit_picks_nearest():
    b = SceneBuilder()
    m = b.lambertian((1, 1, 1))
    b.add_sphere((0, 0, -10), 1.0, m)
    b.add_sphere((0, 0, -5), 1.0, m)
    b.add_sphere((0, 0, -20), 1.0, m)
    scene = b.build(use_bvh=False)
    o = jnp.asarray([[0.0, 0.0, 0.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    hit, t, idx = closest_hit_brute(scene.prims, o, d, 1e-3, INF)
    assert bool(hit[0]) and int(idx[0]) == 1 and np.isclose(float(t[0]), 4.0)


def test_t_max_shrink_respected():
    b = SceneBuilder()
    m = b.lambertian((1, 1, 1))
    b.add_sphere((0, 0, -5), 1.0, m)
    scene = b.build(use_bvh=False)
    o = jnp.asarray([[0.0, 0.0, 0.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    t, valid = prim_intersect_t(
        scene.prims.kind, scene.prims.aux, scene.prims.data, o[:, None], d[:, None],
        1e-3, 3.0,
    )
    assert not bool(valid[0, 0])  # hit at t=4 rejected when t_max=3

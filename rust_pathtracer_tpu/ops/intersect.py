"""Batched ray/primitive intersection (pure-jnp reference implementation).

These are the correctness oracles for the fused bounce
(ops/fused_bounce.py) and the composed path's workhorses; shapes
broadcast so the same code serves both the brute-force (R, P) sweep
and the per-lane gathered BVH leaf tests (R,).

Numeric conventions copied from the reference:
* rays keep **unnormalized** directions; t is in units of |d|;
* sphere: half-b quadratic, nearest root first, inclusive
  [t_min, t_max] (geometry.rs:132-163); negative radius flips normals
  (hollow glass, scene.rs:133);
* rect: plane solve + 2D bounds, fixed +/-axis normal (geometry.rs:210+);
* triangle: Möller-Trumbore with one-sided cull det < 1e-4
  (geometry.rs:519-558), reported uv = (0, 0);
* AABB slab test with swap-on-negative and the *NaN-ignoring* min/max
  the Rust f64::min/max semantics imply (bvh.rs:18-35) — jnp.fmin/fmax.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from rust_pathtracer_tpu import vecmath as vm
from rust_pathtracer_tpu.scene.types import (
    PRIM_RECT,
    PRIM_SPHERE,
    PRIM_TRIANGLE,
    Primitives,
)

# Sentinel "no hit" distance. Large but finite so arithmetic stays NaN-free.
T_MISS = np.float32(3.0e38)

TRI_DET_EPS = 1e-4  # one-sided cull threshold (geometry.rs:526)

# Scenes up to this many primitives carry a static (kind, aux) tuple
# (SceneData.kinds_static): the unrolled static sweep and the fused
# bounce compile one typed test per primitive.
MAX_STATIC_PRIMS = 128

# rect fixed-axis -> (a, b) free axes, ascending (types.py layout)
_RECT_A = np.array([1, 0, 0], np.int32)
_RECT_B = np.array([2, 2, 1], np.int32)


class HitRecord(NamedTuple):
    """Vectorized HitRecord (geometry.rs:9-41)."""

    valid: jnp.ndarray       # bool (...,)
    t: jnp.ndarray           # f32 (...,)
    point: jnp.ndarray       # f32 (..., 3)
    normal: jnp.ndarray      # f32 (..., 3), flipped to oppose the ray
    front_face: jnp.ndarray  # bool (...,)
    u: jnp.ndarray           # f32 (...,)
    v: jnp.ndarray           # f32 (...,)
    mat: jnp.ndarray         # i32 (...,)
    prim: jnp.ndarray        # i32 (...,)


def _axis_onehot(axis_idx, table=None):
    """(...,) int axis index -> (..., 3) one-hot float mask.

    Tables stay numpy: np constants lower straight from host memory
    instead of being eager device arrays captured at trace time.
    """
    idx = axis_idx if table is None else jnp.take(table, axis_idx)
    return (idx[..., None] == np.arange(3, dtype=np.int32)).astype(jnp.float32)


def _pick(vec, axis_idx, table=None):
    """Select per-lane component vec[..., table[axis_idx]] without gathers."""
    return jnp.sum(vec * _axis_onehot(axis_idx, table), axis=-1)


def sphere_t(data, o, d, t_min, t_max):
    """Sphere intersection distance (geometry.rs:132-163)."""
    center = data[..., 0:3]
    radius = data[..., 3]
    oc = o - center
    a = vm.length_squared(d)
    half_b = vm.dot(d, oc)
    c = vm.length_squared(oc) - radius * radius
    dis = half_b * half_b - a * c
    sqrtd = vm.safe_sqrt(dis)  # zero-grad at dis<=0 (miss lanes)
    root1 = (-half_b - sqrtd) / a
    root2 = (-half_b + sqrtd) / a
    ok1 = (root1 >= t_min) & (root1 <= t_max)
    ok2 = (root2 >= t_min) & (root2 <= t_max)
    t = jnp.where(ok1, root1, root2)
    valid = (dis >= 0.0) & (ok1 | ok2)
    return jnp.where(valid, t, T_MISS), valid


def rect_t(data, aux, o, d, t_min, t_max):
    """Axis-aligned rect intersection distance (geometry.rs:210-231 etc.)."""
    k = data[..., 0]
    a0, b0, a1, b1 = data[..., 1], data[..., 2], data[..., 3], data[..., 4]
    o_fix = _pick(o, aux)
    d_fix = _pick(d, aux)
    # parallel rays (d_fix ~ 0) must miss without producing inf/NaN that
    # would poison gradients through the masked-out branch
    parallel = jnp.abs(d_fix) < 1e-30
    t = jnp.where(parallel, T_MISS, (k - o_fix) / jnp.where(parallel, 1.0, d_fix))
    a_val = _pick(o, aux, _RECT_A) + t * _pick(d, aux, _RECT_A)
    b_val = _pick(o, aux, _RECT_B) + t * _pick(d, aux, _RECT_B)
    valid = (
        (t >= t_min)
        & (t <= t_max)
        & (a_val >= a0)
        & (a_val <= a1)
        & (b_val >= b0)
        & (b_val <= b1)
    )
    return jnp.where(valid, t, T_MISS), valid


def triangle_t(data, o, d, t_min, t_max):
    """Möller-Trumbore, one-sided (geometry.rs:519-549)."""
    p1 = data[..., 0:3]
    e1 = data[..., 3:6]
    e2 = data[..., 6:9]
    pvec = vm.cross(d, e2)
    det = vm.dot(e1, pvec)
    # guard the reciprocal; det <= eps lanes are culled anyway
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-30, det, 1.0)
    tvec = o - p1
    u = vm.dot(tvec, pvec) * inv_det
    qvec = vm.cross(tvec, e1)
    v = vm.dot(d, qvec) * inv_det
    t = vm.dot(e2, qvec) * inv_det
    valid = (
        (det >= TRI_DET_EPS)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= t_min)
        & (t <= t_max)
    )
    return jnp.where(valid, t, T_MISS), valid


def prim_intersect_t(kind, aux, data, o, d, t_min, t_max, prim_types=None):
    """Distance to one primitive per lane, dispatching on ``kind``.

    All shapes broadcast; ``prim_types`` (static) skips absent branches.
    Returns (t, valid) with t == T_MISS where invalid.
    """
    types = prim_types if prim_types is not None else (0, 1, 2)
    t = jnp.broadcast_to(T_MISS, jnp.broadcast_shapes(kind.shape, o.shape[:-1]))
    valid = jnp.zeros(t.shape, bool)
    if PRIM_SPHERE in types:
        ts, vs = sphere_t(data, o, d, t_min, t_max)
        sel = (kind == PRIM_SPHERE) & vs
        t = jnp.where(sel, ts, t)
        valid |= sel
    if PRIM_RECT in types:
        tr, vr = rect_t(data, aux, o, d, t_min, t_max)
        sel = (kind == PRIM_RECT) & vr
        t = jnp.where(sel, tr, t)
        valid |= sel
    if PRIM_TRIANGLE in types:
        tt, vt = triangle_t(data, o, d, t_min, t_max)
        sel = (kind == PRIM_TRIANGLE) & vt
        t = jnp.where(sel, tt, t)
        valid |= sel
    return t, valid


def aabb_hit(bbox_min, bbox_max, o, inv_d, t_min, t_max):
    """Slab test (bvh.rs:18-35). ``inv_d`` precomputed; fmax/fmin drop
    the NaNs that arise when a ray origin lies on a zero-thickness slab,
    matching Rust's f64::max/min NaN behavior."""
    t0 = (bbox_min - o) * inv_d
    t1 = (bbox_max - o) * inv_d
    lo = jnp.where(inv_d < 0.0, t1, t0)
    hi = jnp.where(inv_d < 0.0, t0, t1)
    tmin_acc = jnp.fmax(jnp.max(lo, axis=-1), t_min)
    tmax_acc = jnp.fmin(jnp.min(hi, axis=-1), t_max)
    return tmax_acc > tmin_acc


def closest_hit_brute(prims: Primitives, o, d, t_min, t_max, prim_types=None):
    """Closest hit by dense sweep over all P primitives.

    o, d: (R, 3). Returns (hit (R,), t (R,), idx (R,)).  The winner of
    the (R, P) t-matrix argmin reproduces the reference's linear-scan
    closest hit (geometry.rs:71-83) — the regular, divergence-free
    sweep for the small scenes where it beats BVH traversal.
    """
    ob = o[..., None, :]  # (R, 1, 3)
    db = d[..., None, :]
    t, valid = prim_intersect_t(
        prims.kind, prims.aux, prims.data, ob, db, t_min, t_max, prim_types
    )  # (R, P)
    idx = jnp.argmin(t, axis=-1).astype(jnp.int32)
    tbest = jnp.min(t, axis=-1)
    hit = jnp.any(valid, axis=-1)
    return hit, tbest, idx


# Small tables are read per lane through a one-hot contraction at
# HIGHEST precision (exact; differentiable w.r.t. the table).  Above
# this row count the one-hot matrix gets expensive and real gathers
# win.  Whether plain gathers are cheaper below it too on the GPU is
# not yet measured.
ONEHOT_GATHER_MAX_ROWS = 128


def gather_prim_rows(prims: Primitives, idx):
    """prims rows at per-lane indices: (kind, aux, data, mat)."""
    num = prims.kind.shape[0]
    idx = jnp.clip(idx, 0, num - 1)
    if num <= ONEHOT_GATHER_MAX_ROWS:
        onehot = (idx[..., None] == np.arange(num, dtype=np.int32)).astype(
            jnp.float32
        )
        table = jnp.concatenate(
            [
                prims.data,
                prims.kind[:, None].astype(jnp.float32),
                prims.aux[:, None].astype(jnp.float32),
                prims.mat[:, None].astype(jnp.float32),
            ],
            axis=1,
        )  # (P, 15)
        # HIGHEST precision: a default-precision f32 matmul may run in
        # bf16 passes or TF32 and would corrupt f32 table values
        # (geometry coordinates, int codes); at HIGHEST a one-hot
        # contraction is exact.
        rows = jnp.dot(
            onehot,
            table,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        data = rows[..., :12]
        kind = jnp.round(rows[..., 12]).astype(jnp.int32)
        aux = jnp.round(rows[..., 13]).astype(jnp.int32)
        mat = jnp.round(rows[..., 14]).astype(jnp.int32)
        return kind, aux, data, mat
    return prims.kind[idx], prims.aux[idx], prims.data[idx], prims.mat[idx]


def hit_record(
    prims: Primitives, idx, o, d, t, valid, prim_types=None
) -> HitRecord:
    """Build the shading payload for the chosen primitive per lane.

    Reproduces HitRecord::new's front-face flip (geometry.rs:29-41),
    sphere UV (geometry.rs:120-128), rect UV (geometry.rs:225-230 etc.)
    and the triangle's flat normal + uv=(0,0) (geometry.rs:550-558).
    """
    idx = jnp.clip(idx, 0, prims.kind.shape[0] - 1)
    kind, aux, data, mat = gather_prim_rows(prims, idx)
    return record_from_rows(
        kind, aux, data, mat, idx, o, d, t, valid, prim_types
    )


def record_from_rows(
    kind, aux, data, mat, idx, o, d, t, valid, prim_types=None
) -> HitRecord:
    """hit_record body on already-fetched per-lane primitive rows."""
    types = prim_types if prim_types is not None else (0, 1, 2)

    point = o + t[..., None] * d

    outward = jnp.zeros_like(point)
    u = jnp.zeros_like(t)
    v = jnp.zeros_like(t)

    # NOTE: every branch below runs on EVERY lane (masked select), so a
    # rect row flows through the sphere formulas etc.  All denominators
    # are guarded: garbage values are discarded by the `where`, but an
    # inf/NaN forward value would still poison reverse-mode AD.
    def _safe_div(num, den):
        den = jnp.where(jnp.abs(den) < 1e-30, 1.0, den)
        return num / den

    if PRIM_SPHERE in types:
        center = data[..., 0:3]
        radius = data[..., 3]
        n_s = _safe_div(point - center, radius[..., None])  # sign(r) flips normals
        theta = vm.safe_acos(-n_s[..., 1])
        phi = vm.safe_atan2(-n_s[..., 2], n_s[..., 0]) + jnp.pi
        u_s = phi / (2.0 * jnp.pi)
        v_s = theta / jnp.pi
        sel = kind == PRIM_SPHERE
        outward = vm.where(sel, n_s, outward)
        u = jnp.where(sel, u_s, u)
        v = jnp.where(sel, v_s, v)

    if PRIM_RECT in types:
        a0, b0, a1, b1 = data[..., 1], data[..., 2], data[..., 3], data[..., 4]
        direction = data[..., 5]
        n_r = _axis_onehot(aux) * direction[..., None]
        a_val = _pick(point, aux, _RECT_A)
        b_val = _pick(point, aux, _RECT_B)
        u_r = _safe_div(a_val - a0, a1 - a0)
        v_r = _safe_div(b_val - b0, b1 - b0)
        sel = kind == PRIM_RECT
        outward = vm.where(sel, n_r, outward)
        u = jnp.where(sel, u_r, u)
        v = jnp.where(sel, v_r, v)

    if PRIM_TRIANGLE in types:
        sel = kind == PRIM_TRIANGLE
        outward = vm.where(sel, data[..., 9:12], outward)
        # uv stays (0, 0) (geometry.rs:553-556)

    front_face = vm.dot(d, outward) < 0.0
    normal = vm.where(front_face, outward, -outward)

    return HitRecord(
        valid=valid,
        t=t,
        point=point,
        normal=normal,
        front_face=front_face,
        u=u,
        v=v,
        mat=mat,
        prim=idx,
    )


def closest_hit_static(scene, o, d, t_min):
    """Closest hit by the unrolled static-kind sweep (the fused
    bounce's own search, ops/fused_bounce.static_sweep) over
    ``scene.kinds_static``.  Same contract as closest_hit_brute: hit
    masks and winning indices exact, t within a few ulp."""
    from rust_pathtracer_tpu.ops.fused_bounce import static_sweep

    data_t = scene.prims.data.T  # (12, P): row-major scalar reads
    best_t, best_i, _, _, _ = static_sweep(
        scene.kinds_static, lambda row, p: data_t[row, p],
        (o[:, 0], o[:, 1], o[:, 2]), (d[:, 0], d[:, 1], d[:, 2]),
        float(t_min),
    )
    hit = best_i >= 0
    return hit, jnp.where(hit, best_t, T_MISS), jnp.maximum(best_i, 0)


def closest_hit(scene, o, d, t_min, t_max):
    """Scene-level closest hit.  Returns (hit, t, idx).

    Small static scenes take the unrolled static sweep (~2x the masked
    sweep on the H100, PERF.md); scenes with a BVH take the BVH
    traversal; any other scene the masked (R, P) sweep, which is also
    the tests' reference for the other two."""
    from rust_pathtracer_tpu.ops.bvh_traverse import closest_hit_bvh

    if scene.kinds_static is not None:
        return closest_hit_static(scene, o, d, t_min)
    if scene.bvh is None:
        return closest_hit_brute(
            scene.prims, o, d, t_min, t_max, prim_types=scene.prim_types
        )
    return closest_hit_bvh(
        scene.bvh,
        scene.prims,
        o,
        d,
        t_min,
        t_max,
        leaf_size=scene.leaf_size,
        prim_types=scene.prim_types,
    )

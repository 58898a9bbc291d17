"""Stackless wavefront BVH traversal (threaded / skip-link layout).

The reference traverses its pointer BVH recursively per ray
(bvh.rs:106-126), tightening t_max with the left child's hit.  A
vectorized wavefront has no per-lane call stacks, so it walks the flattened
DFS tree in lockstep instead:

    node i interior:  AABB hit  -> next = i + 1 (first child, DFS)
                      AABB miss -> next = miss[i] (skip subtree)
    node i leaf:      test its <= leaf_size primitives, keep best t,
                      next = miss[i]
    node == -1        lane is done

Each lane carries only (node, best_t, best_idx): no stacks, pure gather
traffic on the SoA node arrays, one ``lax.while_loop`` until every lane
terminates.  t_max tightening falls out naturally: the slab test uses
the lane's current best_t (same pruning as bvh.rs:113-117).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rust_pathtracer_tpu.ops.intersect import T_MISS, aabb_hit, prim_intersect_t
from rust_pathtracer_tpu.scene.types import BvhArrays, Primitives


def closest_hit_bvh(
    bvh: BvhArrays,
    prims: Primitives,
    o,
    d,
    t_min,
    t_max,
    leaf_size: int,
    prim_types=None,
):
    """Closest hit via threaded-BVH wavefront traversal.

    o, d: (R, 3). Returns (hit (R,), t (R,), idx (R,)).
    """
    num_prims = prims.kind.shape[0]
    lanes = o.shape[:-1]
    inv_d = 1.0 / d  # inf on zero components, handled by fmax/fmin slab test

    node0 = jnp.zeros(lanes, jnp.int32)
    best_t = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), lanes)
    best_idx = jnp.full(lanes, -1, jnp.int32)

    def cond(state):
        node, _, _ = state
        return jnp.any(node >= 0)

    def body(state):
        node, best_t, best_idx = state
        active = node >= 0
        ni = jnp.clip(node, 0)
        bmin = bvh.bbox_min[ni]
        bmax = bvh.bbox_max[ni]
        miss_link = bvh.miss[ni]
        lfirst = bvh.leaf_first[ni]
        lcount = bvh.leaf_count[ni]

        box = aabb_hit(bmin, bmax, o, inv_d, t_min, best_t) & active
        is_leaf = lcount > 0

        test_leaf = box & is_leaf
        for j in range(leaf_size):
            pj = jnp.clip(lfirst + j, 0, num_prims - 1)
            lane_on = test_leaf & (j < lcount)
            t, valid = prim_intersect_t(
                prims.kind[pj],
                prims.aux[pj],
                prims.data[pj],
                o,
                d,
                t_min,
                best_t,
                prim_types,
            )
            upd = lane_on & valid & (t < best_t)
            best_t = jnp.where(upd, t, best_t)
            best_idx = jnp.where(upd, pj, best_idx)

        nxt = jnp.where(box & ~is_leaf, node + 1, miss_link)
        node = jnp.where(active, nxt, -1)
        return node, best_t, best_idx

    node, best_t, best_idx = jax.lax.while_loop(
        cond, body, (node0, best_t, best_idx)
    )
    hit = best_idx >= 0
    t = jnp.where(hit, best_t, T_MISS)
    return hit, t, best_idx

"""Host-side BVH construction -> flattened threaded (skip-link) arrays.

The reference builds a pointer tree with a *random* split axis and a
median object split (bvh.rs:65-103), traversed recursively with per-call
t_max tightening (bvh.rs:106-126).  Random axes make the tree shape
nondeterministic run-to-run; the traversal recursion does not map to a
lockstep wavefront.

Design (documented deviation; rendered results are identical up to
FP ordering since leaf intersection is exact):

* deterministic split: widest-extent axis of the centroid bounds,
  median (count) split — same O(n log n) shape as the reference but
  reproducible;
* leaves hold up to ``leaf_size`` primitives, contiguous after a
  primitive permutation, so traversal reads them with dense gathers;
* the tree is flattened in DFS order and *threaded*: node i's first
  child is i+1 and ``miss[i]`` skips its subtree — traversal becomes a
  single pointer-chase loop with no stack, ideal for a lockstep ray
  wavefront (see ops/bvh_traverse.py).

A C++ builder (csrc/bvh_builder.cpp, via ctypes) implements the same
algorithm for large meshes; ``build_bvh`` picks it automatically and
this numpy version doubles as its correctness oracle.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

_PENDING = -2


class FlatBvh(NamedTuple):
    bbox_min: np.ndarray    # float32[N, 3]
    bbox_max: np.ndarray    # float32[N, 3]
    miss: np.ndarray        # int32[N]  (-1 terminates traversal)
    leaf_first: np.ndarray  # int32[N]
    leaf_count: np.ndarray  # int32[N]  (0 => interior; first child is i+1)
    prim_order: np.ndarray  # int32[P]  (new position -> old prim index)


def build_bvh_numpy(
    bbox_min: np.ndarray, bbox_max: np.ndarray, leaf_size: int = 4
) -> FlatBvh:
    """Build a threaded BVH over primitive AABBs (numpy reference impl)."""
    n = int(bbox_min.shape[0])
    if n == 0:
        raise ValueError("cannot build BVH over zero primitives")
    bbox_min = np.asarray(bbox_min, np.float32)
    bbox_max = np.asarray(bbox_max, np.float32)
    centroids = 0.5 * (bbox_min + bbox_max)

    max_nodes = 2 * n
    nmin = np.empty((max_nodes, 3), np.float32)
    nmax = np.empty((max_nodes, 3), np.float32)
    miss = np.full(max_nodes, -1, np.int32)
    leaf_first = np.zeros(max_nodes, np.int32)
    leaf_count = np.zeros(max_nodes, np.int32)
    order: list[np.ndarray] = []
    next_node = 0

    # Explicit DFS stack: (prim indices, out_offset, miss_target).
    # A left child's miss (its right sibling's node index) is unknown at
    # push time; mark it _PENDING and resolve in a second pass.
    stack = [(np.arange(n, dtype=np.int64), 0, -1)]
    while stack:
        idx_array, out_offset, miss_target = stack.pop()
        me = next_node
        next_node += 1
        nmin[me] = bbox_min[idx_array].min(axis=0)
        nmax[me] = bbox_max[idx_array].max(axis=0)
        miss[me] = miss_target
        if idx_array.shape[0] <= leaf_size:
            leaf_first[me] = out_offset
            leaf_count[me] = idx_array.shape[0]
            order.append(idx_array)
            continue
        c = centroids[idx_array]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        half = idx_array.shape[0] // 2
        part = np.argpartition(c[:, axis], half)
        left_idx = idx_array[part[:half]]
        right_idx = idx_array[part[half:]]
        # DFS order: left child is emitted next (node me+1); right child
        # is emitted after the whole left subtree.
        stack.append((right_idx, out_offset + left_idx.shape[0], miss_target))
        stack.append((left_idx, out_offset, _PENDING))

    _fix_pending(miss, leaf_count, next_node)

    return FlatBvh(
        bbox_min=nmin[:next_node].copy(),
        bbox_max=nmax[:next_node].copy(),
        miss=miss[:next_node].copy(),
        leaf_first=leaf_first[:next_node].copy(),
        leaf_count=leaf_count[:next_node].copy(),
        prim_order=np.concatenate(order).astype(np.int32),
    )


def _subtree_end(leaf_count: np.ndarray, i: int) -> int:
    """Index one past the end of the subtree rooted at i (DFS layout)."""
    depth = 0
    j = i
    n = leaf_count.shape[0]
    while j < n:
        if leaf_count[j] > 0:  # leaf closes one open interior node
            if depth == 0:
                return j + 1
            depth -= 1
        else:  # interior opens two children; net +1 pending close
            depth += 1
        j += 1
    return n


def _fix_pending(miss: np.ndarray, leaf_count: np.ndarray, nodes: int) -> None:
    """A left child's miss link is its right sibling: the node emitted
    immediately after its own subtree in DFS order."""
    for i in range(nodes):
        if miss[i] == _PENDING:
            miss[i] = _subtree_end(leaf_count, i)


def build_bvh(
    bbox_min: np.ndarray, bbox_max: np.ndarray, leaf_size: int = 4
) -> FlatBvh:
    """Build a threaded BVH, preferring the native C++ builder."""
    try:
        from rust_pathtracer_tpu import native

        if native.available():
            return native.build_bvh(bbox_min, bbox_max, leaf_size)
    except ImportError:
        pass
    return build_bvh_numpy(bbox_min, bbox_max, leaf_size)

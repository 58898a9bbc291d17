"""Flattened SoA scene representation (device-side pytrees).

The reference keeps a heterogeneous pointer soup — ``Box<dyn Hittable>``
primitives holding ``Arc<dyn Material>`` holding ``Box<dyn Texture>``
(geometry.rs:104+, material.rs:24+, texture.rs:9+).  Dynamic dispatch
does not exist in a vectorized wavefront, so the framework flattens the
whole scene into typed tables indexed by small integers:

  Primitives.kind/mat/aux/data  — one row per sphere/rect/triangle
  Materials.kind/tex/fuzz/ir    — lambertian/metal/dielectric/light
  Textures.*                    — solid/checker/perlin/image
  BvhArrays                     — threaded (skip-link) flattened BVH

All arrays are jnp on device; the whole ``SceneData`` is a pytree, so
it can be donated, sharded (replicated) and *differentiated* — texture
colors / image texels / material params are leaves that ``jax.grad``
can reach.

Primitive ``data`` layout (float32[P, 12]):
  sphere   (kind 0): cx cy cz r  .  .  .  .  .  .  .  .        geometry.rs:104
  rect     (kind 1): k a0 b0 a1 b1 dir .  .  .  .  .  .        geometry.rs:182+
      aux = fixed axis (0: YZ-rect, 1: XZ, 2: XY); (a, b) are the two
      free axes in ascending order; dir = outward-normal sign (signum).
  triangle (kind 2): p1(3) e1(3) e2(3) n(3)                    geometry.rs:466
      e1 = p2-p1, e2 = p3-p1, n = flat shading normal.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

PRIM_SPHERE = 0
PRIM_RECT = 1
PRIM_TRIANGLE = 2

MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_LIGHT = 3

TEX_SOLID = 0
TEX_CHECKER = 1
TEX_PERLIN = 2
TEX_IMAGE = 3


class Primitives(NamedTuple):
    kind: jnp.ndarray  # int32[P]
    mat: jnp.ndarray   # int32[P]
    aux: jnp.ndarray   # int32[P]   (rect fixed axis)
    data: jnp.ndarray  # float32[P, 12]


class Materials(NamedTuple):
    kind: jnp.ndarray  # int32[M]
    tex: jnp.ndarray   # int32[M]   albedo / emission texture id
    fuzz: jnp.ndarray  # float32[M] metal fuzz (material.rs:60)
    ir: jnp.ndarray    # float32[M] dielectric index of refraction (material.rs:97)


class Textures(NamedTuple):
    kind: jnp.ndarray     # int32[T]
    color: jnp.ndarray    # float32[T, 3] solid color (texture.rs:9-23)
    child: jnp.ndarray    # int32[T, 2]  checker (odd, even) leaf ids (texture.rs:25-45)
    scale: jnp.ndarray    # float32[T]   perlin scale / checker frequency (10.0 in ref)
    image_id: jnp.ndarray # int32[T]     row into `images`
    images: jnp.ndarray   # float32[I, H, W, 3] padded image stack (no ref counterpart)
    image_hw: jnp.ndarray # int32[I, 2]  valid (h, w) per image
    perlin_seed: jnp.ndarray  # uint32[] scalar perlin hash-stream seed


class BvhArrays(NamedTuple):
    """Threaded (skip-link) flattened BVH in DFS order.

    Node i's first child is i+1 (DFS); ``miss[i]`` jumps over the
    subtree.  Leaves reference ``leaf_count`` reordered primitives
    starting at ``leaf_first`` (interior nodes have leaf_count == 0).
    Replaces the pointer tree of bvh.rs:57-126 with gather-friendly SoA.
    """

    bbox_min: jnp.ndarray    # float32[N, 3]
    bbox_max: jnp.ndarray    # float32[N, 3]
    miss: jnp.ndarray        # int32[N]  (-1 terminates traversal)
    leaf_first: jnp.ndarray  # int32[N]
    leaf_count: jnp.ndarray  # int32[N]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneData:
    """Complete device scene.

    ``leaf_size`` and ``prim_types`` are *static* (pytree aux data): the
    traversal loop unrolls leaf tests ``leaf_size`` times and the
    intersector skips primitive-type branches that the scene does not
    contain, both at compile time.
    """

    prims: Primitives
    materials: Materials
    textures: Textures
    bvh: Optional[BvhArrays]  # None => brute-force closest hit
    leaf_size: int = dataclasses.field(default=4, metadata=dict(static=True))
    prim_types: Tuple[int, ...] = dataclasses.field(
        default=(PRIM_SPHERE, PRIM_RECT, PRIM_TRIANGLE), metadata=dict(static=True)
    )
    tex_types: Tuple[int, ...] = dataclasses.field(
        default=(TEX_SOLID, TEX_CHECKER, TEX_PERLIN, TEX_IMAGE),
        metadata=dict(static=True),
    )
    # max checker nesting depth (texture.rs children are Box<dyn
    # Texture>): the evaluator unrolls this many child resolutions
    checker_depth: int = dataclasses.field(default=1, metadata=dict(static=True))
    mat_types: Tuple[int, ...] = dataclasses.field(
        default=(MAT_LAMBERTIAN, MAT_METAL, MAT_DIELECTRIC, MAT_LIGHT),
        metadata=dict(static=True),
    )
    # per-primitive (kind, aux) tuple for SMALL scenes: lets the static
    # sweep / fused bounce unroll one statically-typed test per
    # primitive (None beyond ops/intersect.MAX_STATIC_PRIMS)
    kinds_static: Optional[Tuple[Tuple[int, int], ...]] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )
    # True when every texture is solid / checker-of-solids / perlin —
    # the whole shading row is then table-free in-register math, which
    # lets the fused bounce (ops/fused_bounce.py) run the
    # entire bounce in one kernel for kinds_static scenes
    shade_static: bool = dataclasses.field(
        default=False, metadata=dict(static=True)
    )

    @property
    def num_prims(self) -> int:
        return self.prims.kind.shape[0]

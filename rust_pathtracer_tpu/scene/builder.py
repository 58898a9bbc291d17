"""Host-side scene assembly: python API -> flattened SoA ``SceneData``.

Mirrors the constructive surface of the reference (scene.rs world
builders, geometry.rs constructors) while producing device tables
instead of a pointer tree.  Boxes are lowered to 6 rects at build time
exactly as ``AABox::new`` does (geometry.rs:391-446); OBJ meshes lower
to triangle rows (obj_model.rs).

Per-primitive AABBs reproduce the reference padding rules:
sphere center +/- |r| (geometry.rs:165-170), rects +/- 1e-4 on the thin
axis (geometry.rs:232-242 etc.), triangles +/- 1e-3 on degenerate axes
(geometry.rs:573-585).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import jax.numpy as jnp

from rust_pathtracer_tpu.bvh import build_bvh
from rust_pathtracer_tpu.scene.types import (
    BvhArrays,
    Materials,
    Primitives,
    SceneData,
    Textures,
    MAT_DIELECTRIC,
    MAT_LAMBERTIAN,
    MAT_LIGHT,
    MAT_METAL,
    PRIM_RECT,
    PRIM_SPHERE,
    PRIM_TRIANGLE,
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_PERLIN,
    TEX_SOLID,
)

# fixed-axis codes for rects; the two free axes (a, b) in ascending order
_RECT_FREE_AXES = {0: (1, 2), 1: (0, 2), 2: (0, 1)}
_RECT_NAME_TO_AXIS = {"yz": 0, "xz": 1, "xy": 2}

ColorLike = Union[Sequence[float], np.ndarray]

# Brute-force closest hit is used below this primitive count (a
# regular, divergence-free sweep; set on a 16 GB TPU, not yet measured
# on the card), BVH traversal above it.
BVH_AUTO_THRESHOLD = 64


class SceneBuilder:
    def __init__(self, perlin_seed: int = 0):
        self._tex_kind: List[int] = []
        self._tex_color: List[np.ndarray] = []
        self._tex_child: List[tuple] = []
        self._tex_scale: List[float] = []
        self._tex_image: List[int] = []
        self._images: List[np.ndarray] = []

        self._mat_kind: List[int] = []
        self._mat_tex: List[int] = []
        self._mat_fuzz: List[float] = []
        self._mat_ir: List[float] = []

        self._prim_kind: List[int] = []
        self._prim_mat: List[int] = []
        self._prim_aux: List[int] = []
        self._prim_data: List[np.ndarray] = []
        self._bbox_min: List[np.ndarray] = []
        self._bbox_max: List[np.ndarray] = []

        self.perlin_seed = perlin_seed

    # ------------------------------------------------------------------
    # textures
    # ------------------------------------------------------------------
    def solid_texture(self, color: ColorLike) -> int:
        """SolidColorTexture (texture.rs:9-23)."""
        return self._push_tex(TEX_SOLID, color=color)

    def checker_texture(self, odd: int, even: int, frequency: float = 10.0) -> int:
        """CheckerTexture over two texture ids (texture.rs:25-45).

        sign(sin(f x) sin(f y) sin(f z)) < 0 selects ``odd``; the
        reference hard-codes f = 10.  Children may be ANY texture —
        including other checkers (texture.rs takes Box<dyn Texture>);
        nesting depth is resolved statically at build time and the
        evaluator unrolls that many child-resolution steps.
        """
        for child in (odd, even):
            if not 0 <= child < len(self._tex_kind):
                raise ValueError(f"unknown child texture id {child}")
        return self._push_tex(TEX_CHECKER, child=(odd, even), scale=frequency)

    def perlin_texture(self, scale: float) -> int:
        """PerlinNoiseTexture marble pattern (texture.rs:47-81)."""
        return self._push_tex(TEX_PERLIN, scale=scale)

    def image_texture(self, image: np.ndarray) -> int:
        """Image texture sampled by (u, v) with bilinear filtering.

        No reference counterpart (the reference has solid/checker/perlin
        only); provided for the differentiable-texel path.
        ``image``: float array (H, W, 3) in linear color.
        """
        img = np.asarray(image, np.float32)
        if img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError("image must be (H, W, 3)")
        self._images.append(img)
        return self._push_tex(TEX_IMAGE, image=len(self._images) - 1)

    def _push_tex(self, kind, color=(0, 0, 0), child=(0, 0), scale=0.0, image=0) -> int:
        self._tex_kind.append(kind)
        self._tex_color.append(np.asarray(color, np.float32))
        self._tex_child.append(tuple(child))
        self._tex_scale.append(float(scale))
        self._tex_image.append(int(image))
        return len(self._tex_kind) - 1

    # ------------------------------------------------------------------
    # materials
    # ------------------------------------------------------------------
    def _tex_or_color(self, tex: Union[int, ColorLike]) -> int:
        if isinstance(tex, (int, np.integer)):
            return int(tex)
        return self.solid_texture(tex)

    def lambertian(self, albedo: Union[int, ColorLike]) -> int:
        """LambertianMaterial (material.rs:24-56); albedo = texture id or color."""
        return self._push_mat(MAT_LAMBERTIAN, tex=self._tex_or_color(albedo))

    def metal(self, albedo: Union[int, ColorLike], fuzz: float) -> int:
        """MetalMaterial (material.rs:58-94)."""
        return self._push_mat(MAT_METAL, tex=self._tex_or_color(albedo), fuzz=fuzz)

    def dielectric(self, index_of_refraction: float) -> int:
        """DielectricMaterial (material.rs:96-144)."""
        return self._push_mat(MAT_DIELECTRIC, ir=index_of_refraction)

    def diffuse_light(self, emit: Union[int, ColorLike]) -> int:
        """DiffuseLightMaterial, one-sided emitter (material.rs:146-167)."""
        return self._push_mat(MAT_LIGHT, tex=self._tex_or_color(emit))

    def _push_mat(self, kind, tex=0, fuzz=0.0, ir=1.0) -> int:
        self._mat_kind.append(kind)
        self._mat_tex.append(int(tex))
        self._mat_fuzz.append(float(fuzz))
        self._mat_ir.append(float(ir))
        return len(self._mat_kind) - 1

    # ------------------------------------------------------------------
    # primitives
    # ------------------------------------------------------------------
    def add_sphere(self, center: ColorLike, radius: float, material: int) -> int:
        """Sphere; negative radius gives a hollow-glass inner shell whose
        normals point inward (geometry.rs:104-171, used in scene.rs:133,148)."""
        c = np.asarray(center, np.float32)
        r = float(radius)
        data = np.zeros(12, np.float32)
        data[0:3] = c
        data[3] = r
        ar = abs(r)
        return self._push_prim(
            PRIM_SPHERE, material, 0, data, c - ar, c + ar
        )

    def add_rect(
        self, plane: str, start: ColorLike, end: ColorLike, direction: float, material: int
    ) -> int:
        """Axis-aligned rectangle; ``plane`` in {"xy", "xz", "yz"}.

        Reproduces RectangleXY/XZ/YZ::new (geometry.rs:189-207 etc.):
        validates alignment, canonicalizes min/max corners, and stores
        sign(direction) as the fixed outward-normal sign.
        """
        start = np.asarray(start, np.float64)
        end = np.asarray(end, np.float64)
        fixed = _RECT_NAME_TO_AXIS[plane.lower()]
        a_ax, b_ax = _RECT_FREE_AXES[fixed]
        if start[fixed] != end[fixed]:
            raise ValueError(f"rectangle is not axis aligned on {'xyz'[fixed]}")
        k = float(start[fixed])
        a0, a1 = sorted((float(start[a_ax]), float(end[a_ax])))
        b0, b1 = sorted((float(start[b_ax]), float(end[b_ax])))
        data = np.zeros(12, np.float32)
        data[0] = k
        data[1], data[2] = a0, b0
        data[3], data[4] = a1, b1
        data[5] = np.sign(direction) if direction != 0 else 0.0
        bmin = np.zeros(3, np.float32)
        bmax = np.zeros(3, np.float32)
        bmin[a_ax], bmax[a_ax] = a0, a1
        bmin[b_ax], bmax[b_ax] = b0, b1
        bmin[fixed], bmax[fixed] = k - 1e-4, k + 1e-4  # geometry.rs:236-241
        return self._push_prim(PRIM_RECT, material, fixed, data, bmin, bmax)

    def add_box(self, start: ColorLike, end: ColorLike, material: int) -> List[int]:
        """Axis-aligned box lowered to 6 outward-facing rects
        (AABox::new, geometry.rs:391-446)."""
        start = np.asarray(start, np.float64)
        end = np.asarray(end, np.float64)
        mn = np.minimum(start, end)
        mx = np.maximum(start, end)
        ids = [
            self.add_rect("xy", (mn[0], mn[1], mn[2]), (mx[0], mx[1], mn[2]), -1.0, material),
            self.add_rect("xy", (mn[0], mn[1], mx[2]), (mx[0], mx[1], mx[2]), 1.0, material),
            self.add_rect("xz", (mn[0], mn[1], mn[2]), (mx[0], mn[1], mx[2]), -1.0, material),
            self.add_rect("xz", (mn[0], mx[1], mn[2]), (mx[0], mx[1], mx[2]), 1.0, material),
            self.add_rect("yz", (mn[0], mn[1], mn[2]), (mn[0], mx[1], mx[2]), -1.0, material),
            self.add_rect("yz", (mx[0], mn[1], mn[2]), (mx[0], mx[1], mx[2]), 1.0, material),
        ]
        return ids

    def add_triangle(
        self,
        p1: ColorLike,
        p2: ColorLike,
        p3: ColorLike,
        material: int,
        normal: Optional[ColorLike] = None,
    ) -> int:
        """One-sided triangle (geometry.rs:466-589).  ``normal`` defaults
        to the geometric normal (p2-p1)x(p3-p1) normalized
        (``new_without_normal``, geometry.rs:502-515)."""
        p1 = np.asarray(p1, np.float64)
        p2 = np.asarray(p2, np.float64)
        p3 = np.asarray(p3, np.float64)
        if normal is None:
            n = np.cross(p2 - p1, p3 - p1)
            n = n / max(np.linalg.norm(n), 1e-30)
        else:
            n = np.asarray(normal, np.float64)
        data = np.zeros(12, np.float32)
        data[0:3] = p1
        data[3:6] = p2 - p1
        data[6:9] = p3 - p1
        data[9:12] = n
        bmin = np.minimum(np.minimum(p1, p2), p3)
        bmax = np.maximum(np.maximum(p1, p2), p3)
        flat = bmin == bmax
        bmin = np.where(flat, bmin - 1e-3, bmin)  # geometry.rs:573-585
        bmax = np.where(flat, bmax + 1e-3, bmax)
        return self._push_prim(
            PRIM_TRIANGLE, material, 0, data, bmin.astype(np.float32), bmax.astype(np.float32)
        )

    def add_triangles(
        self,
        vertices: np.ndarray,  # (T, 3, 3)
        materials: np.ndarray,  # (T,) int
        normals: Optional[np.ndarray] = None,  # (T, 3)
    ) -> None:
        """Bulk triangle ingestion (OBJ meshes)."""
        vertices = np.asarray(vertices, np.float64)
        tcount = vertices.shape[0]
        if normals is None:
            e1 = vertices[:, 1] - vertices[:, 0]
            e2 = vertices[:, 2] - vertices[:, 0]
            n = np.cross(e1, e2)
            n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
        else:
            n = np.asarray(normals, np.float64)
        data = np.zeros((tcount, 12), np.float32)
        data[:, 0:3] = vertices[:, 0]
        data[:, 3:6] = vertices[:, 1] - vertices[:, 0]
        data[:, 6:9] = vertices[:, 2] - vertices[:, 0]
        data[:, 9:12] = n
        bmin = vertices.min(axis=1)
        bmax = vertices.max(axis=1)
        flat = bmin == bmax
        bmin = np.where(flat, bmin - 1e-3, bmin)
        bmax = np.where(flat, bmax + 1e-3, bmax)
        for i in range(tcount):
            self._push_prim(
                PRIM_TRIANGLE,
                int(materials[i]),
                0,
                data[i],
                bmin[i].astype(np.float32),
                bmax[i].astype(np.float32),
            )

    def add_obj(self, path: str, default_material: Optional[int] = None) -> None:
        """Load a Wavefront OBJ (+MTL) into triangles, mapping materials
        as obj_model.rs:28-50 does (illum 7 -> dielectric, illum 5 ->
        metal with fuzz = 1/shininess, else lambertian; missing material
        -> lambertian (0.2, 0.7, 0.2))."""
        from rust_pathtracer_tpu.scene.obj_loader import load_obj_into

        load_obj_into(self, path, default_material=default_material)

    def _push_prim(self, kind, mat, aux, data, bmin, bmax) -> int:
        self._prim_kind.append(kind)
        self._prim_mat.append(int(mat))
        self._prim_aux.append(int(aux))
        self._prim_data.append(np.asarray(data, np.float32))
        self._bbox_min.append(np.asarray(bmin, np.float32))
        self._bbox_max.append(np.asarray(bmax, np.float32))
        return len(self._prim_kind) - 1

    # ------------------------------------------------------------------
    # build
    # ------------------------------------------------------------------
    @property
    def num_prims(self) -> int:
        return len(self._prim_kind)

    def build(
        self,
        use_bvh: Union[str, bool] = "auto",
        leaf_size: int = 4,
    ) -> SceneData:
        if not self._prim_kind:
            raise ValueError("scene has no primitives")
        if not self._mat_kind:
            raise ValueError("scene has no materials")

        prim_kind = np.asarray(self._prim_kind, np.int32)
        prim_mat = np.asarray(self._prim_mat, np.int32)
        prim_aux = np.asarray(self._prim_aux, np.int32)
        prim_data = np.stack(self._prim_data)
        bbox_min = np.stack(self._bbox_min)
        bbox_max = np.stack(self._bbox_max)

        if use_bvh == "auto":
            use_bvh = len(self._prim_kind) > BVH_AUTO_THRESHOLD

        bvh_arrays = None
        if use_bvh:
            flat = build_bvh(bbox_min, bbox_max, leaf_size=leaf_size)
            order = flat.prim_order
            prim_kind = prim_kind[order]
            prim_mat = prim_mat[order]
            prim_aux = prim_aux[order]
            prim_data = prim_data[order]
            bvh_arrays = BvhArrays(
                bbox_min=jnp.asarray(flat.bbox_min),
                bbox_max=jnp.asarray(flat.bbox_max),
                miss=jnp.asarray(flat.miss),
                leaf_first=jnp.asarray(flat.leaf_first),
                leaf_count=jnp.asarray(flat.leaf_count),
            )

        if self._images:
            hmax = max(im.shape[0] for im in self._images)
            wmax = max(im.shape[1] for im in self._images)
            images = np.zeros((len(self._images), hmax, wmax, 3), np.float32)
            image_hw = np.zeros((len(self._images), 2), np.int32)
            for i, im in enumerate(self._images):
                images[i, : im.shape[0], : im.shape[1]] = im
                image_hw[i] = (im.shape[0], im.shape[1])
        else:
            images = np.zeros((1, 1, 1, 3), np.float32)
            image_hw = np.ones((1, 2), np.int32)

        from rust_pathtracer_tpu.ops.intersect import MAX_STATIC_PRIMS

        # static checker nesting depth: how many child-resolution steps
        # the evaluator must unroll (texture ids only reference earlier
        # ids, so this terminates; 1 for the reference scenes)
        checker_depth = 0
        depth_of = []
        for k, (c0, c1) in zip(self._tex_kind, self._tex_child):
            d = 1 + max(depth_of[c0], depth_of[c1]) if k == TEX_CHECKER else 0
            depth_of.append(d)
            checker_depth = max(checker_depth, d)

        # shading is table-free (fused-bounce eligible) when every
        # texture is solid / perlin / checker whose children are both
        # solid leaves
        shade_static = all(
            k in (TEX_SOLID, TEX_PERLIN)
            or (
                k == TEX_CHECKER
                and self._tex_kind[c0] == TEX_SOLID
                and self._tex_kind[c1] == TEX_SOLID
            )
            for k, (c0, c1) in zip(self._tex_kind, self._tex_child)
        )

        return SceneData(
            leaf_size=int(leaf_size) if use_bvh else 0,
            prim_types=tuple(sorted(set(int(k) for k in prim_kind))),
            tex_types=tuple(sorted(set(self._tex_kind))) if self._tex_kind else (),
            checker_depth=checker_depth,
            mat_types=tuple(sorted(set(self._mat_kind))),
            kinds_static=(
                tuple(
                    (int(k), int(a)) for k, a in zip(prim_kind, prim_aux)
                )
                if len(prim_kind) <= MAX_STATIC_PRIMS
                else None
            ),
            shade_static=shade_static,
            prims=Primitives(
                kind=jnp.asarray(prim_kind),
                mat=jnp.asarray(prim_mat),
                aux=jnp.asarray(prim_aux),
                data=jnp.asarray(prim_data),
            ),
            materials=Materials(
                kind=jnp.asarray(np.asarray(self._mat_kind, np.int32)),
                tex=jnp.asarray(np.asarray(self._mat_tex, np.int32)),
                fuzz=jnp.asarray(np.asarray(self._mat_fuzz, np.float32)),
                ir=jnp.asarray(np.asarray(self._mat_ir, np.float32)),
            ),
            textures=Textures(
                kind=jnp.asarray(np.asarray(self._tex_kind, np.int32)),
                color=jnp.asarray(
                    np.stack(self._tex_color)
                    if self._tex_color
                    else np.zeros((1, 3), np.float32)
                ),
                child=jnp.asarray(
                    np.asarray(self._tex_child, np.int32).reshape(-1, 2)
                    if self._tex_child
                    else np.zeros((1, 2), np.int32)
                ),
                scale=jnp.asarray(
                    np.asarray(self._tex_scale, np.float32)
                    if self._tex_scale
                    else np.zeros(1, np.float32)
                ),
                image_id=jnp.asarray(
                    np.asarray(self._tex_image, np.int32)
                    if self._tex_image
                    else np.zeros(1, np.int32)
                ),
                images=jnp.asarray(images),
                image_hw=jnp.asarray(image_hw),
                perlin_seed=jnp.asarray(self.perlin_seed, jnp.uint32),
            ),
            bvh=bvh_arrays,
        )

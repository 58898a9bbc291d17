"""Vectorized texture-table evaluation.

Replaces ``Box<dyn Texture>`` dynamic dispatch (texture.rs:5-7) with a
masked select over the texture table for a whole wavefront at once.
Checker resolves its child id first (one level of indirection — the
reference nests arbitrarily but every scene uses leaf children), then
all leaves evaluate together.

Differentiability: solid colors and image texels are pytree leaves of
``Textures`` — gradients w.r.t. them flow through this evaluation.
"""

from __future__ import annotations

import jax.numpy as jnp

from rust_pathtracer_tpu import perlin as perlin_mod
from rust_pathtracer_tpu.ops import table
from rust_pathtracer_tpu.scene.types import (
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_PERLIN,
    TEX_SOLID,
    Textures,
)


def eval_texture(textures: Textures, tex_id, u, v, point, tex_types=None,
                 checker_depth=1):
    """value(u, v, p) for per-lane texture ids.

    tex_id: (R,) int32; u, v: (R,); point: (R, 3).  Returns (R, 3).
    ``tex_types`` (static) skips branches for texture kinds the scene
    does not contain; ``checker_depth`` (static) is the scene's max
    checker nesting depth — each unrolled step resolves one level of
    child indirection (texture.rs:25-45 children are Box<dyn Texture>,
    so arbitrary nesting is expressible).
    """
    types = tex_types if tex_types is not None else (0, 1, 2, 3)
    kind, scale, child = table.lookup(
        tex_id, textures.kind, textures.scale, textures.child
    )

    if TEX_CHECKER in types:
        for _ in range(max(checker_depth, 1)):
            # sines = sin(f x) sin(f y) sin(f z); < 0 -> odd child
            # (texture.rs:38-44; the reference hard-codes f = 10).
            s = jnp.sin(scale[..., None] * point)
            sines = s[..., 0] * s[..., 1] * s[..., 2]
            picked = jnp.where(sines < 0.0, child[..., 0], child[..., 1])
            tex_id = jnp.where(kind == TEX_CHECKER, picked, tex_id)
            kind, scale, child = table.lookup(
                tex_id, textures.kind, textures.scale, textures.child
            )

    out = jnp.zeros(point.shape, point.dtype)

    if TEX_SOLID in types:
        (color,) = table.lookup(tex_id, textures.color)
        out = jnp.where((kind == TEX_SOLID)[..., None], color, out)

    if TEX_PERLIN in types:
        gray = perlin_mod.marble(point, textures.perlin_seed, scale)
        out = jnp.where((kind == TEX_PERLIN)[..., None], gray[..., None], out)

    if TEX_IMAGE in types:
        img_val = _sample_image(textures, tex_id, u, v)
        out = jnp.where((kind == TEX_IMAGE)[..., None], img_val, out)

    return out


def _sample_image(textures: Textures, tex_id, u, v):
    """Bilinear sample of the padded image stack.

    Convention (RTiOW-style; no reference counterpart): x = u * (w-1),
    y = (1 - v) * (h-1), clamped.  Differentiable w.r.t. texels.
    """
    img_id = textures.image_id[tex_id]
    return _sample_image_by_id(textures, img_id, u, v)


def _sample_image_by_id(textures: Textures, img_id, u, v):
    hw = textures.image_hw[img_id]
    h = hw[..., 0].astype(jnp.float32)
    w = hw[..., 1].astype(jnp.float32)
    x = jnp.clip(u, 0.0, 1.0) * (w - 1.0)
    y = (1.0 - jnp.clip(v, 0.0, 1.0)) * (h - 1.0)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    x1i = jnp.minimum(x0i + 1, hw[..., 1] - 1)
    y1i = jnp.minimum(y0i + 1, hw[..., 0] - 1)

    def texel(yy, xx):
        return textures.images[img_id, yy, xx]

    c00 = texel(y0i, x0i)
    c01 = texel(y0i, x1i)
    c10 = texel(y1i, x0i)
    c11 = texel(y1i, x1i)
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy

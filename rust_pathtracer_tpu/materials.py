"""Masked material dispatch for the ray wavefront.

Replaces ``dyn Material`` virtual calls (material.rs:15-22) with a
4-way masked select: every branch is computed for every lane (cheap on
the vector units) and combined by material id.  Semantics match the reference
exactly:

* lambertian — dir = normal + random-on-unit-sphere; degenerate
  (near-zero) direction falls back to the normal (material.rs:41-47);
* metal — mirror reflection of the *unit* incident direction; the ray
  is ABSORBED (no scatter, only emitted light survives) when the
  unfuzzed reflection points below the surface (material.rs:77-93: the
  dot test runs before fuzz is added);
* dielectric — eta ratio flips with front_face, total internal
  reflection OR a stochastic Schlick coin chooses reflect vs refract,
  attenuation is exactly (1,1,1) (material.rs:117-143).  Quirk kept:
  Schlick is evaluated with the eta *ratio*, not the absolute IOR
  (material.rs:109-113,128);
* diffuse light — never scatters; emits only on the front face
  (material.rs:159-166).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from rust_pathtracer_tpu import vecmath as vm
from rust_pathtracer_tpu.ops import table
from rust_pathtracer_tpu.ops.intersect import HitRecord
from rust_pathtracer_tpu.scene.types import (
    MAT_DIELECTRIC,
    MAT_LAMBERTIAN,
    MAT_LIGHT,
    MAT_METAL,
)
from rust_pathtracer_tpu.textures import eval_texture


class ScatterResult(NamedTuple):
    did_scatter: jnp.ndarray  # bool (R,)
    direction: jnp.ndarray    # f32 (R, 3) — unnormalized, like the reference
    attenuation: jnp.ndarray  # f32 (R, 3)


class ShadeInputs(NamedTuple):
    """Per-lane material parameters + evaluated texture color.

    Computed ONCE per bounce (the same texture value serves emission
    and albedo — each material has a single texture, material.rs) from
    the material/texture tables.
    """

    kind: jnp.ndarray   # i32 (R,) material kind
    fuzz: jnp.ndarray   # f32 (R,)
    ir: jnp.ndarray     # f32 (R,)
    value: jnp.ndarray  # f32 (R, 3) texture value at the hit


def shade_inputs(scene, hit: HitRecord) -> ShadeInputs:
    """Build ShadeInputs from the material/texture tables."""
    mats = scene.materials
    kind, tex, fuzz, ir = table.lookup(
        hit.mat, mats.kind, mats.tex, mats.fuzz, mats.ir
    )
    # dielectric-only scenes have no texture consumers (attenuation
    # is fixed (1,1,1), material.rs:141) and may carry empty tables
    needs_value = (
        (MAT_LAMBERTIAN in scene.mat_types)
        or (MAT_METAL in scene.mat_types)
        or (MAT_LIGHT in scene.mat_types)
    )
    value = (
        eval_texture(
            scene.textures, tex, hit.u, hit.v, hit.point, scene.tex_types,
            checker_depth=scene.checker_depth,
        )
        if needs_value
        else jnp.zeros_like(hit.point)
    )
    return ShadeInputs(kind, fuzz, ir, value)


def emitted(scene, hit: HitRecord, si: ShadeInputs = None):
    """Emitted radiance at the hit (material.rs:159-166): light material
    only, gated on front_face (one-sided emitters)."""
    if MAT_LIGHT not in scene.mat_types:
        return jnp.zeros_like(hit.point)
    if si is None:
        si = shade_inputs(scene, hit)
    on = (si.kind == MAT_LIGHT) & hit.front_face
    return jnp.where(on[..., None], si.value, 0.0)


def scatter(scene, hit: HitRecord, d_in, sphere_dir, ball_dir, coin,
            si: ShadeInputs = None) -> ScatterResult:
    """Scatter the wavefront off its hit materials.

    d_in: incident (unnormalized) directions; sphere_dir: per-lane
    uniform points ON the unit sphere; ball_dir: per-lane uniform points
    IN the unit ball; coin: per-lane U[0,1) for the dielectric's
    reflect/refract choice.
    """
    if si is None:
        si = shade_inputs(scene, hit)
    kind, fuzz, ir, albedo = si.kind, si.fuzz, si.ir, si.value
    n = hit.normal

    did = jnp.zeros(kind.shape, bool)
    direction = jnp.zeros_like(d_in)
    attenuation = jnp.zeros_like(albedo)

    if MAT_LAMBERTIAN in scene.mat_types:
        d_l = n + sphere_dir
        d_l = vm.where(vm.near_zero(d_l), n, d_l)  # material.rs:44-47
        sel = kind == MAT_LAMBERTIAN
        did |= sel
        direction = vm.where(sel, d_l, direction)
        attenuation = vm.where(sel, albedo, attenuation)

    if MAT_METAL in scene.mat_types:
        refl = vm.reflect(vm.normalize(d_in), n)
        ok = vm.dot(refl, n) > 0.0  # absorb below-surface (material.rs:80,91)
        d_m = refl + fuzz[..., None] * ball_dir
        sel = kind == MAT_METAL
        did |= sel & ok
        direction = vm.where(sel, d_m, direction)
        attenuation = vm.where(sel, albedo, attenuation)

    if MAT_DIELECTRIC in scene.mat_types:
        ratio = jnp.where(hit.front_face, 1.0 / ir, ir)  # material.rs:118-122
        ud = vm.normalize(d_in)
        cos_t = jnp.minimum(vm.dot(-ud, n), 1.0)
        sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
        cannot_refract = ratio * sin_t > 1.0
        reflect_coin = _schlick(cos_t, ratio) > coin  # material.rs:126-131
        choose_reflect = cannot_refract | reflect_coin
        d_d = vm.where(
            choose_reflect, vm.reflect(ud, n), vm.refract(ud, n, ratio)
        )
        sel = kind == MAT_DIELECTRIC
        did |= sel
        direction = vm.where(sel, d_d, direction)
        attenuation = vm.where(sel, jnp.ones_like(attenuation), attenuation)

    # MAT_LIGHT: default no-scatter (material.rs:16-18)
    return ScatterResult(did_scatter=did, direction=direction, attenuation=attenuation)


def _schlick(cosine, refraction_index):
    """Schlick approximation r0 + (1-r0)(1-cos)^5 (material.rs:109-113)."""
    r0 = ((1.0 - refraction_index) / (1.0 + refraction_index)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5

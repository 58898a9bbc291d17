"""Batched 3-vector math on ``(..., 3)`` jnp arrays.

Vectorized replacement for the reference's scalar ``Vec3`` class
(vec3.rs:10-254).  There is no vector *object*: every op is a pure
function over arrays whose trailing axis is xyz, so a whole ray
wavefront is one SIMD value.  All ops are differentiable and guarded
against the classic ``where``-NaN-gradient traps.
"""

from __future__ import annotations

import jax.numpy as jnp

# Reference: NEAR_ZERO = 1e-8 (vec3.rs:7).  We run f32, where 1e-8 is
# below the representable relative precision of typical dir components;
# keep the same constant — the test is "all |c| < eps" and only guards
# the degenerate lambertian direction (material.rs:44).
NEAR_ZERO = 1e-8

# Tiny guard for normalization to avoid 0/0 NaNs inside masked-out lanes.
_SAFE_EPS = 1e-20


def vec3(x, y, z, dtype=jnp.float32):
    """Stack components into a (..., 3) array."""
    return jnp.stack(
        [jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype)],
        axis=-1,
    )


def dot(a, b):
    """Batched dot product (vec3.rs:87-89). Returns (...)."""
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    """Batched cross product (vec3.rs:93-99)."""
    return jnp.cross(a, b)


def length_squared(v):
    """|v|^2 (vec3.rs:83-85)."""
    return jnp.sum(v * v, axis=-1)


def length(v):
    """|v| (vec3.rs:79-81)."""
    return jnp.sqrt(length_squared(v))


def normalize(v):
    """v / |v| (``unit_vector``, vec3.rs:101-103), safe at |v|≈0."""
    return v / jnp.sqrt(jnp.maximum(length_squared(v), _SAFE_EPS))[..., None]


def near_zero(v):
    """True where every |component| < NEAR_ZERO (vec3.rs:110-112)."""
    return jnp.all(jnp.abs(v) < NEAR_ZERO, axis=-1)


def reflect(v, n):
    """Mirror reflection v - 2(v·n)n (vec3.rs:114-116)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(v, n, etai_over_etat):
    """Snell refraction of *unit* v about unit n (vec3.rs:118-127).

    cos_theta = min(-v·n, 1); out_perp = eta*(v + cos*n);
    out_parallel = -sqrt(|1 - |out_perp|^2|) * n.
    ``etai_over_etat`` broadcasts with shape (...).
    """
    cos_theta = jnp.minimum(dot(-v, n), 1.0)
    eta = jnp.asarray(etai_over_etat)[..., None]
    out_perp = eta * (v + cos_theta[..., None] * n)
    # reference takes abs() before sqrt (vec3.rs:121-125); safe_sqrt also
    # keeps the gradient finite at the total-internal-reflection edge.
    out_parallel = -safe_sqrt(jnp.abs(1.0 - length_squared(out_perp)))[..., None] * n
    return out_perp + out_parallel


def where(mask, a, b):
    """Select (...,3) vectors by (...) mask."""
    return jnp.where(mask[..., None], a, b)


# --- gradient-safe transcendentals ------------------------------------
# acos'(x) and atan2 are unbounded/undefined at the sphere-UV poles;
# masked-out lanes would still poison reverse-mode AD with 0 * inf = NaN
# (the classic `where` trap).  These route pole lanes through constants:
# forward values stay exact, pole gradients become 0 (the detached-
# sampling convention for unbounded geometric derivatives).

_POLE_EPS = 1e-6


def safe_acos(x):
    xc = jnp.clip(x, -1.0, 1.0)
    is_pole = jnp.abs(xc) >= 1.0 - _POLE_EPS
    xs = jnp.where(is_pole, 0.0, xc)
    pole_val = jnp.where(xc > 0.0, 0.0, jnp.pi)
    return jnp.where(is_pole, pole_val, jnp.arccos(xs))


def safe_atan2(y, x):
    degenerate = (jnp.abs(x) < 1e-12) & (jnp.abs(y) < 1e-12)
    xs = jnp.where(degenerate, 1.0, x)
    ys = jnp.where(degenerate, 0.0, y)
    return jnp.where(degenerate, 0.0, jnp.arctan2(ys, xs))


def safe_sqrt(x):
    """sqrt with zero gradient at 0 instead of inf."""
    is_zero = x <= 0.0
    xs = jnp.where(is_zero, 1.0, x)
    return jnp.where(is_zero, 0.0, jnp.sqrt(xs))

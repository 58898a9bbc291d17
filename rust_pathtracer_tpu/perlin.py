"""Deterministic gather-free Perlin noise (improved Perlin, hashed lattice).

The reference delegates to the ``noise`` crate with a *random* seed per
run (texture.rs:55), which makes its perlin scenes unreproducible.  The
framework fixes the seed (default 0) so images are deterministic, and
evaluates noise fully vectorized over ``(..., 3)`` point batches.

The classic permutation-table hash chain ``perm[perm[perm[ix] + iy] +
iz]`` is three *serial per-lane gathers* per corner.  This
implementation replaces the table with an arithmetic integer hash
(multiply-xorshift mix of the lattice coordinates + seed) computed
entirely in registers — which is also what lets the fused bounce
evaluate it per lane with no table lookup.  Corner gradients, quintic fade, and
trilinear blending are the standard improved-Perlin construction, so
zero-at-lattice and C1 continuity are preserved; only the (already
seed-dependent) hash values differ from the ``noise`` crate.

Marble pattern + turbulence follow texture.rs:60-80:
  turb(p, depth=7) = | sum_k 0.5^k * noise(2^k * p) |
  value = 0.5 * (1 - sin(scale * z + 10 * turb(p)))
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

TURBULENCE_DEPTH = 7  # texture.rs:80


def _fade(t):
    # 6t^5 - 15t^4 + 10t^3 (improved Perlin quintic)
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _hash3(ix, iy, iz, seed):
    """Arithmetic lattice hash -> uint32; gather-free (registers only).

    lowbias32-style finalizer over a multiplicative combine of the
    three lattice coordinates.  Adjacent cells sharing a corner see the
    same hash, which is all Perlin continuity requires.
    """
    h = (
        ix.astype(jnp.uint32) * np.uint32(0x8DA6B343)
        ^ iy.astype(jnp.uint32) * np.uint32(0xD8163841)
        ^ iz.astype(jnp.uint32) * np.uint32(0xCB1AB31F)
    ) + seed.astype(jnp.uint32)
    h = h ^ (h >> 15)
    h = h * np.uint32(0x2C1B3C6D)
    h = h ^ (h >> 12)
    h = h * np.uint32(0x297A2D39)
    h = h ^ (h >> 15)
    return h


def _grad(h, x, y, z):
    """Gradient dot product for hashed corner h (improved Perlin set)."""
    h = (h & np.uint32(15)).astype(jnp.int32)
    u = jnp.where(h < 8, x, y)
    v = jnp.where(h < 4, y, jnp.where((h == 12) | (h == 14), x, z))
    return jnp.where(h & 1 == 0, u, -u) + jnp.where(h & 2 == 0, v, -v)


def noise3(points, seed=0):
    """Improved Perlin noise at (..., 3) points; output roughly [-1, 1].

    ``seed`` is a scalar (int or 0-d array) selecting the hash stream —
    the replacement for the reference's per-run-random permutation
    table (texture.rs:55).
    """
    return noise3_planes(
        points[..., 0], points[..., 1], points[..., 2], seed
    )


def noise3_planes(pxp, pyp, pzp, seed=0):
    """noise3 on separate component planes (any matching shapes).

    Same math bit-for-bit as the stacked entry point; the plane form is
    what the fused bounce calls (ops/fused_bounce.py), so the texture
    path has ONE implementation in the fused and the composed bounce.
    """
    seed = jnp.asarray(seed, jnp.uint32)
    xf, yf, zf = jnp.floor(pxp), jnp.floor(pyp), jnp.floor(pzp)
    ix, iy, iz = (f.astype(jnp.int32) for f in (xf, yf, zf))
    x, y, z = pxp - xf, pyp - yf, pzp - zf

    u, v, w = _fade(x), _fade(y), _fade(z)

    n000 = _grad(_hash3(ix, iy, iz, seed), x, y, z)
    n100 = _grad(_hash3(ix + 1, iy, iz, seed), x - 1.0, y, z)
    n010 = _grad(_hash3(ix, iy + 1, iz, seed), x, y - 1.0, z)
    n110 = _grad(_hash3(ix + 1, iy + 1, iz, seed), x - 1.0, y - 1.0, z)
    n001 = _grad(_hash3(ix, iy, iz + 1, seed), x, y, z - 1.0)
    n101 = _grad(_hash3(ix + 1, iy, iz + 1, seed), x - 1.0, y, z - 1.0)
    n011 = _grad(_hash3(ix, iy + 1, iz + 1, seed), x, y - 1.0, z - 1.0)
    n111 = _grad(_hash3(ix + 1, iy + 1, iz + 1, seed), x - 1.0, y - 1.0, z - 1.0)

    def lerp(t, lo, hi):
        return lo + t * (hi - lo)

    return lerp(
        w,
        lerp(v, lerp(u, n000, n100), lerp(u, n010, n110)),
        lerp(v, lerp(u, n001, n101), lerp(u, n011, n111)),
    )


def turbulence(points, seed=0, depth: int = TURBULENCE_DEPTH):
    """|sum_k 0.5^k noise(2^k p)| (texture.rs:60-72)."""
    return turbulence_planes(
        points[..., 0], points[..., 1], points[..., 2], seed, depth
    )


def turbulence_planes(px, py, pz, seed=0, depth: int = TURBULENCE_DEPTH):
    acc = jnp.zeros(px.shape, px.dtype)
    weight = 1.0
    for _ in range(depth):
        acc = acc + weight * noise3_planes(px, py, pz, seed)
        weight *= 0.5
        px, py, pz = px * 2.0, py * 2.0, pz * 2.0
    return jnp.abs(acc)


def marble(points, seed, scale):
    """Marble pattern 0.5*(1 - sin(scale*z + 10*turb(p))) (texture.rs:76-80).

    Returns (...,) grayscale values in [0, 1].
    """
    return marble_planes(
        points[..., 0], points[..., 1], points[..., 2], seed, scale
    )


def marble_planes(px, py, pz, seed, scale):
    t = turbulence_planes(px, py, pz, seed)
    return 0.5 * (1.0 - jnp.sin(scale * pz + 10.0 * t))

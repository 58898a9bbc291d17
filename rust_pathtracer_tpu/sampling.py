"""Counter-based random sampling for the wavefront path tracer.

The reference draws from a mutable per-thread RNG with rejection loops
(``random_in_unitsphere`` vec3.rs:41-49, ``random_in_unitdisk_xy``
vec3.rs:55-67), which is nondeterministic run-to-run and does not
vectorize.  The wavefront design replaces both ideas:

* **Counter-based keys** — every ray lane owns a threefry key derived
  from ``fold_in(base_key, pixel_id * spp + sample_id)``.  Images are
  bitwise reproducible for a given base key regardless of chunking,
  sharding, or resume point (the reference cannot do this at all).
* **Analytic sampling** — rejection loops are replaced by closed-form
  transforms drawing the *same distributions*: uniform-on-sphere via
  (z, phi), uniform-in-ball via cube-root radius scaling, uniform-in-disk
  via sqrt radius.

Per-bounce decorrelation uses ``fold_in(lane_key, bounce * _STRIDE + purpose)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# purpose tags for per-bounce draws
P_PIXEL_JITTER = 0  # 2 uniforms (renderer.rs:22-25)
P_LENS = 1          # 2 uniforms for the aperture disk (camera.rs:47)
P_LAMBERT = 2       # 2 uniforms: on-sphere dir (material.rs:42)
P_FUZZ = 3          # 3 uniforms: in-ball dir (material.rs:84)
P_SCHLICK = 4       # 1 uniform: reflect/refract coin (material.rs:128)
P_ROULETTE = 5      # 1 uniform: optional russian roulette (not in reference)
_STRIDE = 8


def lane_keys(base_key, counters):
    """Per-lane keys from int32/uint32 lane counters, shape (R,) -> (R,2)."""
    return jax.vmap(jax.random.fold_in, in_axes=(None, 0))(base_key, counters)


def bounce_keys(lkeys, bounce, purpose):
    """Fold (bounce, purpose) into per-lane keys. ``bounce`` may be a
    scalar (chunked wavefront) or a per-lane array (regeneration
    wavefront, where every lane sits at its own path depth); the same
    (key, bounce, purpose) always yields the same draw either way."""
    tag = bounce * _STRIDE + purpose
    in_axes = (0, 0) if jnp.ndim(tag) else (0, None)
    return jax.vmap(jax.random.fold_in, in_axes=in_axes)(lkeys, tag)


def _uniforms(keys, n):
    """n iid U[0,1) per lane; keys (R,2) -> (R, n)."""
    return jax.vmap(lambda k: jax.random.uniform(k, (n,), jnp.float32))(keys)


def uniform(keys):
    """One U[0,1) per lane, shape (R,)."""
    return _uniforms(keys, 1)[..., 0]


def uniform2(keys):
    """Two U[0,1) per lane, shape (R, 2)."""
    return _uniforms(keys, 2)


def uniform3(keys):
    """Three U[0,1) per lane, shape (R, 3)."""
    return _uniforms(keys, 3)


def on_unit_sphere_from_u(u):
    """on_unit_sphere's trig transform from (R, 2) uniforms.

    Split out so the RNG-hoist path (integrator._precompute_draws) can
    precompute only the bit-exact uniforms and leave the trig in the
    loop body: transcendentals are the one shape-sensitive piece (XLA
    vectorizes them differently per batch shape, ulp-level), so they
    must run at the SAME shape in every path that claims bitwise
    estimator identity (cascade == plain)."""
    z = 2.0 * u[..., 0] - 1.0
    phi = (2.0 * jnp.pi) * u[..., 1]
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def on_unit_sphere(keys):
    """Uniform direction on S^2, shape (R, 3).

    Same distribution as the reference's rejection-sample-then-normalize
    (``random_on_unitsphere`` vec3.rs:51-53), computed analytically:
    z = 2u-1, phi = 2*pi*v, r = sqrt(1-z^2).
    """
    return on_unit_sphere_from_u(_uniforms(keys, 2))


def in_unit_sphere_from_u(u):
    """in_unit_sphere's transform from (R, 3) uniforms (see
    on_unit_sphere_from_u for why this is split)."""
    z = 2.0 * u[..., 0] - 1.0
    phi = (2.0 * jnp.pi) * u[..., 1]
    rho = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    d = jnp.stack([rho * jnp.cos(phi), rho * jnp.sin(phi), z], axis=-1)
    return d * jnp.cbrt(u[..., 2])[..., None]


def in_unit_sphere(keys):
    """Uniform point in the unit ball, shape (R, 3).

    Same distribution as rejection sampling (vec3.rs:41-49): uniform
    direction scaled by U^(1/3).
    """
    return in_unit_sphere_from_u(_uniforms(keys, 3))


def in_unit_disk_xy(keys):
    """Uniform point in the unit disk in the xy plane, shape (R, 3).

    Same distribution as rejection sampling (vec3.rs:55-67):
    r = sqrt(u), theta = 2*pi*v, z = 0.
    """
    u = _uniforms(keys, 2)
    r = jnp.sqrt(u[..., 0])
    theta = (2.0 * jnp.pi) * u[..., 1]
    return jnp.stack(
        [r * jnp.cos(theta), r * jnp.sin(theta), jnp.zeros_like(r)], axis=-1
    )


# ---------------------------------------------------------------------------
# packed scatter draws: counter-mode threefry, 4 blocks per lane-bounce
# ---------------------------------------------------------------------------
#
# The per-purpose scheme above costs ~5.3 threefry-block-equivalents
# per lane-bounce (a fold_in chain per purpose + a generate each).
# The packed layout below draws the SAME distributions from 4 blocks:
# the lane key itself is the threefry key (unique per (pixel, sample)
# — chunk/shard/resume invariance preserved), the counter words are
# (bounce, block j) — a 64-bit counter space, no fold chains.
#
# Streams never collide with the legacy per-purpose draws: those
# generate under fold_in-DERIVED keys, these under the raw lane key —
# distinct threefry keys.  Pixel jitter and lens draws (bounce 0,
# amortized over the whole path) stay on the legacy scheme.
#
# Packed was a trade on the machine it was written for: cheaper in
# the diff step, dearer in the nondiff forward that dominates
# production rendering — so the DEFAULT stays legacy; packed remains
# opt-in (RPT_RNG_SCHEME=packed).  Not yet measured on the GPU.  A
# packed run uses a different stream (goldens would shift; the
# estimator is unchanged).  Time RNG draws in-step: standalone probes
# under-measure via dead-code elimination.

_TF_C240 = 0x1BD11BDA
_ROT_EVEN = (13, 15, 26, 6)
_ROT_ODD = (17, 29, 16, 24)


def _threefry2x32(k0, k1, x0, x1):
    """Spec threefry-2x32, 20 rounds, elementwise over any shape."""
    import numpy as np

    k2 = k0 ^ k1 ^ jnp.uint32(_TF_C240)
    ks = (k0, k1, k2)
    x0 = x0 + k0
    x1 = x1 + k1
    for i in range(5):
        for r in (_ROT_EVEN if i % 2 == 0 else _ROT_ODD):
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + jnp.uint32(i + 1)
    return x0, x1


def _bits_to_unit(w):
    """uint32 -> U[0,1) with 24-bit resolution (exact in f32)."""
    return (w >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(2.0 ** -24)


def scatter_uniforms(lkeys, bounce, with_roulette):
    """All of one bounce's scatter draws from 4 threefry blocks.

    ``lkeys`` (R, 2) per-lane keys; ``bounce`` scalar, (R,) per-lane
    (regen wavefront), or any shape broadcastable against (R,).
    Returns (sphere_u (.., R, 2), ball_u (.., R, 3), coin (.., R),
    roulette (.., R) or None).  Word layout: block j in 0..3 yields
    words (2j, 2j+1); purposes use words 0-6 in the P_* order.
    """
    k0 = lkeys[..., 0]
    k1 = lkeys[..., 1]
    b = jnp.asarray(bounce, jnp.uint32)
    b, k0, k1 = jnp.broadcast_arrays(b, k0, k1)
    words = []
    for j in range(4):
        w0, w1 = _threefry2x32(k0, k1, b, jnp.full_like(b, j))
        words.extend([w0, w1])
    u = [_bits_to_unit(w) for w in words]
    sphere_u = jnp.stack(u[0:2], axis=-1)
    ball_u = jnp.stack(u[2:5], axis=-1)
    coin = u[5]
    roulette = u[6] if with_roulette else None
    return sphere_u, ball_u, coin, roulette


def bounce_draws(lkeys, bounce, with_roulette):
    """One bounce's scatter uniforms under the ACTIVE scheme.

    The single chooser every draw site goes through (chunked scan,
    fused-cols scan, regen wavefront, resume paths), so the estimator
    can never mix schemes within a render.  RPT_RNG_SCHEME=legacy
    (default) = the per-purpose fold chains; =packed = the opt-in
    counter-mode 4-block draws (a different stream).  Returns
    (sphere_u, ball_u, coin, roulette|None).
    """
    import os

    if os.environ.get("RPT_RNG_SCHEME", "legacy") == "packed":
        return scatter_uniforms(lkeys, bounce, with_roulette)
    su = uniform2(bounce_keys(lkeys, bounce, P_LAMBERT))
    bu = uniform3(bounce_keys(lkeys, bounce, P_FUZZ))
    cn = uniform(bounce_keys(lkeys, bounce, P_SCHLICK))
    rl = (uniform(bounce_keys(lkeys, bounce, P_ROULETTE))
          if with_roulette else None)
    return su, bu, cn, rl

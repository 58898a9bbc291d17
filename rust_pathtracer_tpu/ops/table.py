"""Exact one-hot table lookup for small SoA tables.

Per-lane reads of tiny tables (materials, textures, primitive rows)
go through a one-hot contraction at HIGHEST precision: bitwise exact
for f32 payloads and differentiable w.r.t. the table.  Used for every
per-lane table access in the composed shading path.  (Chosen on a
TPU, where gathers were slow; whether plain gathers are cheaper on the
GPU is not yet measured.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# beyond this row count the one-hot matrix outgrows the gather cost
ONEHOT_MAX_ROWS = 128


def lookup(idx, *columns):
    """Row lookup ``tuple(col[idx] for col in columns)``.

    idx: (R,) int; each column: (N,) or (N, K) array.  Uses a one-hot
    contraction when N <= ONEHOT_MAX_ROWS, gathers otherwise.
    Integer columns round-trip exactly (one-hot sums are exact).
    """
    n = columns[0].shape[0]
    if n > ONEHOT_MAX_ROWS:
        return tuple(c[idx] for c in columns)

    parts = []
    meta = []  # (dtype, width)
    for c in columns:
        c2 = c[:, None] if c.ndim == 1 else c
        meta.append((c.dtype, c2.shape[1], c.ndim))
        parts.append(c2.astype(jnp.float32))
    table = jnp.concatenate(parts, axis=1)  # (N, K_total)

    onehot = (idx[..., None] == np.arange(n, dtype=np.int32)).astype(jnp.float32)
    rows = jnp.dot(
        onehot,
        table,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )

    out = []
    k = 0
    for dtype, width, ndim in meta:
        sl = rows[..., k : k + width]
        if ndim == 1:
            sl = sl[..., 0]
        if jnp.issubdtype(dtype, jnp.integer) or dtype == jnp.bool_:
            sl = jnp.round(sl).astype(dtype)
        out.append(sl)
        k += width
    return tuple(out)

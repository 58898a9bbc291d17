"""Device mesh construction + multi-host bring-up.

The reference's only parallelism is rayon's shared-memory work stealing
over pixels (renderer.rs:14-18).  The framework scales the same two
axes the renderer exposes — pixels and samples — across a
``jax.sharding.Mesh``:

* ``tiles``   — pixel tiles (the rayon axis, now across chips)
* ``samples`` — samples-per-pixel batches; partial radiance sums are
  combined with a ``psum`` over this axis (the renderer's counterpart
  of data-parallel gradient all-reduce)

On a multi-host slice, ``distributed_init`` wires up jax.distributed;
the same mesh code then spans all hosts' devices, with tile shards
riding ICI within a host/slice and DCN across slices.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh

TILE_AXIS = "tiles"
SAMPLE_AXIS = "samples"


def make_mesh(
    tiles: Optional[int] = None,
    samples: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (tiles, samples) mesh over the available devices."""
    devs = list(devices) if devices is not None else jax.devices()
    n = len(devs)
    if tiles is None:
        if n % samples != 0:
            raise ValueError(f"{n} devices not divisible by samples={samples}")
        tiles = n // samples
    if tiles * samples != n:
        raise ValueError(f"mesh {tiles}x{samples} != {n} devices")
    arr = np.asarray(devs).reshape(tiles, samples)
    return Mesh(arr, (TILE_AXIS, SAMPLE_AXIS))


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host process bring-up (jax.distributed.initialize).

    No reference counterpart — the reference is single-process by
    construction (SURVEY §2).  Call once per host before building
    meshes; with no arguments, uses the cluster-provided environment.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )

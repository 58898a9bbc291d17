"""shard_map distributed rendering over a (tiles, samples) mesh.

Maps the reference's rayon pixel fan-out (renderer.rs:14-18) onto a
device mesh:

* pixel ids are sharded over the ``tiles`` axis — each device traces
  only its tile of the image (scene tables replicate; they are small);
* the spp loop splits over the ``samples`` axis — each samples-group
  traces a disjoint sample range for the same pixels and partial sums
  are combined with one ``lax.psum`` (an XLA collective; NCCL on GPUs);
* the counter-based RNG (render.py) keys off (pixel, sample) globally,
  so the sharded image is bitwise-identical to the single-device one.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from rust_pathtracer_tpu.camera import Camera
from rust_pathtracer_tpu.integrator import TraceStats
from rust_pathtracer_tpu.parallel.mesh import SAMPLE_AXIS, TILE_AXIS
from rust_pathtracer_tpu.render import RenderSettings, trace_pixel_lanes


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class ShardedChunkPlan:
    """One jitted shard_map step per sample chunk.

    Exposing chunk granularity at the host level lets callers persist
    the (mesh-agnostic) accumulation state between device dispatches —
    the sharded checkpoint/resume path (SURVEY §5 failure slot).
    """

    def __init__(self, scene, cam: Camera, settings: RenderSettings, key,
                 mesh, background=None):
        self.settings = settings
        width, height = settings.width, settings.height
        spp = settings.samples_per_pixel
        n_tiles = mesh.shape[TILE_AXIS]
        n_samples_axis = mesh.shape[SAMPLE_AXIS]

        self.n_samples_axis = n_samples_axis
        self.npix = npix = width * height
        npix_pad = _round_up(npix, n_tiles)
        # each samples-group owns a contiguous sample range
        self.spp_shard = spp_shard = -(-spp // n_samples_axis)
        self.chunk = chunk = min(settings.resolve_chunk(), spp_shard)
        self.n_chunks = -(-spp_shard // chunk)
        pix_per_tile = npix_pad // n_tiles
        self.lanes_per_shard = pix_per_tile * chunk

        bg = jnp.asarray(
            settings.background if background is None else background,
            jnp.float32,
        )
        self._args = (scene, cam, key, bg)

        # static cascade per shard: all compaction ops are shard-local
        # (integrator.trace_cascaded_static), so each tile compacts its
        # own lanes with zero cross-shard communication; the
        # occupancy[-1] overflow guard psums across shards.  "auto" is
        # resolved by render_radiance_sharded and
        # render_radiance_sharded_checkpointed (chunk-0 calibration
        # with worst-shard pmax occupancy) BEFORE plan construction —
        # explicit schedules only here.
        cascade_stages = None
        if not settings.differentiable and (
            settings.cascade or settings.cascade_schedule
        ):
            from rust_pathtracer_tpu.render import _cascade_static_schedule

            sched = settings.cascade_schedule
            st = _cascade_static_schedule(
                settings.max_bounces, pix_per_tile * chunk,
                sched if sched != "auto" else None,
            )
            cascade_stages = tuple(st) if st else None
            if cascade_stages is None and sched != "auto":
                import warnings

                warnings.warn(
                    "sharded render: cascade requested but no "
                    "applicable STATIC schedule (dynamic boundaries "
                    f"are single-chip-only; got "
                    f"{sched!r} for {pix_per_tile * chunk} lanes/"
                    "shard) — rendering the plain chunked path",
                    stacklevel=3,
                )
        self.cascade_stages = cascade_stages

        def tile_chunk(scene, cam, key, bg, c):
            # derive this device's pixel ids from its mesh coordinate —
            # no sharded input arrays, so the same code runs under
            # multi-host jax.distributed without host-local/global
            # array conversions.  padded ids wrap to pixel 0 harmlessly
            # and are cropped later.
            tile = jax.lax.axis_index(TILE_AXIS).astype(jnp.uint32)
            pix = (
                tile * np.uint32(pix_per_tile)
                + jnp.arange(pix_per_tile, dtype=jnp.uint32)
            ) % np.uint32(npix)
            s_group = jax.lax.axis_index(SAMPLE_AXIS)
            base = (s_group * spp_shard).astype(jnp.uint32)
            part, stats = trace_pixel_lanes(
                scene,
                cam,
                key,
                pix,
                base + c * jnp.uint32(chunk),
                bg,
                width=width,
                height=height,
                spp_chunk=chunk,
                spp_total=spp,
                max_bounces=settings.max_bounces,
                rr_start=settings.russian_roulette_start,
                differentiable=settings.differentiable,
                cascade_stages=cascade_stages,
            )
            # combine sample-partial sums (the renderer's "all-reduce")
            acc = jax.lax.psum(part, SAMPLE_AXIS)
            segments = jax.lax.psum(stats.segments, (SAMPLE_AXIS, TILE_AXIS))
            bounces = jax.lax.pmax(stats.bounces, (SAMPLE_AXIS, TILE_AXIS))
            occupancy = jax.lax.psum(
                stats.occupancy, (SAMPLE_AXIS, TILE_AXIS)
            )
            # worst-SHARD occupancy: the auto-schedule calibration
            # needs per-shard live counts (slice widths are per shard),
            # and tiles are heterogeneous (sky tiles die early).
            # stop_gradient: pmax has no differentiation rule, and this
            # is diagnostics — without it the differentiable sharded
            # train step fails to transpose
            occ_max = jax.lax.pmax(
                jax.lax.stop_gradient(stats.occupancy),
                (SAMPLE_AXIS, TILE_AXIS),
            )
            return acc, segments, bounces, occupancy, occ_max

        self._run = jax.jit(jax.shard_map(
            tile_chunk,
            mesh=mesh,
            in_specs=(P(), P(), P(), P(), P()),
            out_specs=(P(TILE_AXIS), P(), P(), P(), P()),
        ))

    def run_chunk(self, c: int):
        """Trace sample-chunk ``c``; returns (acc (npix_pad, 3) sharded
        over tiles, segments, bounces, occupancy, occ_max) — acc is
        this chunk's radiance SUM (already psum'd over the samples
        axis); occ_max is the worst-shard occupancy histogram."""
        return self._run(*self._args, jnp.uint32(c))

    def finalize(self, acc, segments, bounces, occupancy):
        spp = self.settings.samples_per_pixel
        img = (acc[: self.npix] / jnp.float32(spp)).reshape(
            self.settings.height, self.settings.width, 3
        )
        return img, TraceStats(
            segments=segments, bounces=bounces, occupancy=occupancy
        )


def _run_chunks(plan, first, totals=None):
    """Run chunks [first, n_chunks) accumulating onto ``totals``
    (acc, segments, bounces, occupancy) — totals=None starts fresh."""
    acc = segments = bounces = occupancy = None
    if totals is not None:
        acc, segments, bounces, occupancy = totals
    for c in range(first, plan.n_chunks):
        a, s, b, o, _om = plan.run_chunk(c)
        if acc is None:
            acc, segments, bounces, occupancy = a, s, b, o
        else:
            # donated carry: no other reference holds acc (render.py
            # _accumulate; the sharded totals resume path passes fresh
            # device arrays), so the buffer is reused in place
            from rust_pathtracer_tpu.render import _accumulate

            acc = _accumulate(acc, a)
            segments = segments + s
            bounces = bounces + b  # sum over chunks (matches render.py)
            occupancy = occupancy + o
    return acc, segments, bounces, occupancy


def render_radiance_sharded(
    scene,
    cam: Camera,
    settings: RenderSettings,
    key,
    mesh,
    background=None,
):
    """Distributed render; returns ((H, W, 3) radiance, TraceStats).

    The image lives sharded over ``tiles`` until the final host gather.

    Static-cascade safety mirrors render.py: an explicit schedule that
    drops live lanes (psum'd occupancy[-1] > 0) raises
    CascadeOverflowError; cascade_schedule="auto" calibrates on
    chunk 0 (plain path, worst-shard pmax occupancy -> per-shard
    widths), renders the rest cascaded, and auto-widens + re-renders
    on overflow.
    """
    import dataclasses
    import warnings

    from rust_pathtracer_tpu.render import (
        AUTO_MARGIN,
        CascadeOverflowError,
        _derive_cascade_schedule,
    )

    auto = (
        settings.cascade_schedule == "auto"
        and not settings.differentiable
    )
    if not auto:
        plan = ShardedChunkPlan(scene, cam, settings, key, mesh, background)
        totals = _run_chunks(plan, 0)
        if plan.cascade_stages and float(totals[3][-1]) > 0.0:
            raise CascadeOverflowError(
                f"sharded static cascade schedule "
                f"{settings.cascade_schedule!r} dropped "
                f"{float(totals[3][-1]):.0f} live lanes across shards "
                "(occupancy[-1] > 0): the image is biased.  Widen the "
                "schedule or use cascade_schedule='auto'."
            )
        return plan.finalize(*totals)

    # auto: chunk 0 on the plain path doubles as the calibration run
    plain = dataclasses.replace(settings, cascade=False,
                                cascade_schedule=None)
    plan0 = ShardedChunkPlan(scene, cam, plain, key, mesh, background)
    a0, s0, b0, o0, om0 = plan0.run_chunk(0)
    if plan0.n_chunks == 1:
        return plan0.finalize(a0, s0, b0, o0)

    om0_host = np.asarray(om0)

    def chunk0_totals():
        # _run_chunks DONATES the accumulator it is handed: each
        # attempt gets its own copy of chunk 0's, so an overflow retry
        # (or the plain fallback) never reads a consumed buffer
        return jnp.copy(a0), s0, b0, o0

    margin = AUTO_MARGIN
    for _attempt in range(3):
        sched = _derive_cascade_schedule(
            om0_host, plan0.lanes_per_shard, settings.max_bounces,
            margin=margin,
        )
        if sched is None:
            break  # no boundary pays: plain path for the rest
        plan1 = ShardedChunkPlan(
            scene, cam,
            dataclasses.replace(settings, cascade=True,
                                cascade_schedule=sched),
            key, mesh, background,
        )
        if not plan1.cascade_stages:
            break
        totals = _run_chunks(plan1, 1, chunk0_totals())
        # overflow = the CASCADED chunks' guard slot only: chunk 0 ran
        # on the plain path, where occupancy[-1] is a real alive count
        # whenever max_bounces >= MAX_BOUNCE_STATS - 1 (the histogram
        # clamps deeper bounces into the last slot) — counting it
        # would spuriously "overflow" every deep-bounce auto render
        if float(totals[3][-1] - o0[-1]) == 0.0:
            return plan1.finalize(*totals)
        warnings.warn(
            f"sharded auto cascade schedule {sched!r} dropped "
            f"{float(totals[3][-1]):.0f} live lanes — re-deriving at "
            f"margin {margin * 2:g} and re-rendering",
            stacklevel=2,
        )
        margin *= 2.0

    totals = _run_chunks(plan0, 1, chunk0_totals())
    return plan0.finalize(*totals)

"""Render checkpoint / exact resume.

The reference has NO intra-frame recovery: a crash loses the whole
frame (SURVEY §5 — failure handling is panic!/expect).  Here the
accumulation state (radiance sums + samples completed + base RNG key)
checkpoints to disk between sample chunks, and resume is EXACT: the
counter-based RNG replays the remaining (pixel, sample) lanes
identically, so a resumed render is bitwise identical to an
uninterrupted one.
"""

from __future__ import annotations

import os
import tempfile
from typing import NamedTuple, Optional

import numpy as np


class RenderCheckpoint(NamedTuple):
    acc: np.ndarray          # (H*W, 3) radiance sums over completed samples
    samples_done: int        # completed per-samples-group chunk offset
    width: int
    height: int
    spp_total: int
    key_data: np.ndarray     # PRNGKey raw data
    segments: float
    # sharded renders: the samples-axis extent and chunk size the sums
    # were taken with (each samples-group owns a disjoint sample range,
    # so completed samples are only well-defined for a matching split;
    # the TILE count is free to change on resume)
    samples_axis: int = 1
    chunk: int = 0           # 0 = single-device legacy (chunk implied)


def save_checkpoint(path: str, ckpt: RenderCheckpoint) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # atomic write: render crash mid-save must not corrupt the file
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)))
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                acc=ckpt.acc,
                samples_done=ckpt.samples_done,
                width=ckpt.width,
                height=ckpt.height,
                spp_total=ckpt.spp_total,
                key_data=ckpt.key_data,
                segments=ckpt.segments,
                samples_axis=ckpt.samples_axis,
                chunk=ckpt.chunk,
            )
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str) -> Optional[RenderCheckpoint]:
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return RenderCheckpoint(
            acc=z["acc"],
            samples_done=int(z["samples_done"]),
            width=int(z["width"]),
            height=int(z["height"]),
            spp_total=int(z["spp_total"]),
            key_data=z["key_data"],
            segments=float(z["segments"]),
            samples_axis=int(z["samples_axis"]) if "samples_axis" in z else 1,
            chunk=int(z["chunk"]) if "chunk" in z else 0,
        )


def render_radiance_checkpointed(
    scene,
    cam,
    settings,
    key,
    checkpoint_path: str,
    checkpoint_every: int = 1,
):
    """Chunked render that persists progress; resumes from
    ``checkpoint_path`` if it exists and matches the job shape."""
    import jax.numpy as jnp

    from rust_pathtracer_tpu.integrator import TraceStats
    from rust_pathtracer_tpu.render import (
        _render_chunk,
        _render_chunk_cascaded,
    )

    use_cascade = (
        settings.cascade or settings.cascade_schedule is not None
    ) and not settings.differentiable
    # "auto": the probe derivation is deterministic for a given
    # (scene, camera, settings, key), so a resumed run re-derives the
    # IDENTICAL schedule — resume stays bitwise-exact
    schedule = settings.cascade_schedule
    auto = schedule == "auto" and use_cascade
    if auto:
        from rust_pathtracer_tpu.render import derive_cascade_schedule

        schedule = derive_cascade_schedule(scene, cam, settings, key)
    static_applies = False
    if use_cascade:
        from rust_pathtracer_tpu.render import _cascade_static_schedule

        static_applies = bool(_cascade_static_schedule(
            settings.max_bounces,
            settings.width * settings.height * settings.resolve_chunk(),
            schedule,
        ))

    spp = settings.samples_per_pixel
    chunk = settings.resolve_chunk()
    bg = jnp.asarray(settings.background, jnp.float32)
    key_data = np.asarray(key)

    start = 0
    acc = jnp.zeros((settings.width * settings.height, 3), jnp.float32)
    segments = 0.0
    ckpt = load_checkpoint(checkpoint_path)
    if ckpt is not None:
        matches = (
            ckpt.width == settings.width
            and ckpt.height == settings.height
            and ckpt.spp_total == spp
            and np.array_equal(ckpt.key_data, key_data)
        )
        if matches:
            start = ckpt.samples_done
            acc = jnp.asarray(ckpt.acc)
            segments = ckpt.segments

    # segments / overflow accumulate ON DEVICE between checkpoints: a
    # float() fetch is a host sync, so the loop only syncs when it actually persists (every
    # ``checkpoint_every`` chunks).  The window guard runs at each
    # save: an EXPLICIT schedule that dropped live lanes raises
    # CascadeOverflowError (callers like the CLI's pinned auto
    # schedule catch it and re-derive); an "auto" schedule re-renders
    # the whole window on the always-exact plain path instead — the
    # recovery is a deterministic function of (scene, cam, key, chunk
    # range), so resume stays bitwise-exact and overflow is never
    # surfaced for a schedule the renderer itself derived.
    seg_dev = jnp.float32(0.0)
    overflow_dev = jnp.float32(0.0)
    # rollback state at the last checkpoint + the window's chunk starts
    acc_save, seg_save = acc, seg_dev
    window: list = []

    def plain_chunk(s0):
        return _render_chunk(
            scene, cam, key, jnp.uint32(s0), bg,
            width=settings.width,
            height=settings.height,
            spp_chunk=chunk,
            spp_total=spp,
            max_bounces=settings.max_bounces,
            rr_start=settings.russian_roulette_start,
            differentiable=settings.differentiable,
        )

    def guard(acc, seg_dev, overflow_dev):
        """Returns (acc, seg_dev) with the window made exact."""
        if static_applies and float(overflow_dev) > 0.0:
            if not auto:
                from rust_pathtracer_tpu.render import CascadeOverflowError

                raise CascadeOverflowError(
                    f"static cascade schedule {schedule!r} dropped "
                    f"{float(overflow_dev):.0f} live lanes in a "
                    "checkpointed window: the image is biased."
                )
            # auto recovery: discard the window's biased chunks and
            # re-render them on the plain path
            acc, seg_dev = acc_save, seg_save
            for s0w in window:
                part, stats = plain_chunk(s0w)
                acc = acc + part
                seg_dev = seg_dev + stats.segments
        return acc, seg_dev

    chunk_index = 0
    for s0 in range(start, spp, chunk):
        window.append(s0)
        if use_cascade:
            part, stats = _render_chunk_cascaded(
                scene, cam, key, jnp.uint32(s0), bg,
                width=settings.width,
                height=settings.height,
                spp_chunk=chunk,
                spp_total=spp,
                max_bounces=settings.max_bounces,
                rr_start=settings.russian_roulette_start,
                schedule=schedule,
            )
            if static_applies:
                overflow_dev = overflow_dev + stats.occupancy[-1]
        else:
            part, stats = plain_chunk(s0)
        acc = acc + part
        seg_dev = seg_dev + stats.segments
        chunk_index += 1
        if chunk_index % checkpoint_every == 0:
            acc, seg_dev = guard(acc, seg_dev, overflow_dev)
            overflow_dev = jnp.float32(0.0)
            acc_save, seg_save = acc, seg_dev
            window = []
            save_checkpoint(
                checkpoint_path,
                RenderCheckpoint(
                    acc=np.asarray(acc),
                    samples_done=min(s0 + chunk, spp),
                    width=settings.width,
                    height=settings.height,
                    spp_total=spp,
                    key_data=key_data,
                    segments=segments + float(seg_dev),
                ),
            )
    acc, seg_dev = guard(acc, seg_dev, overflow_dev)
    segments += float(seg_dev)

    img = (acc / jnp.float32(spp)).reshape(settings.height, settings.width, 3)
    from rust_pathtracer_tpu.integrator import MAX_BOUNCE_STATS

    return img, TraceStats(
        segments=jnp.float32(segments),
        bounces=jnp.int32(0),
        occupancy=jnp.zeros((MAX_BOUNCE_STATS,), jnp.float32),
    )


def render_radiance_sharded_checkpointed(
    scene,
    cam,
    settings,
    key,
    mesh,
    checkpoint_path: str,
    checkpoint_every: int = 1,
):
    """Sharded render (parallel/shard.py) with per-chunk checkpointing.

    The persisted state is the full-image radiance sums + per-group
    chunk progress + base key.  A job can resume with a DIFFERENT tile
    count (the counter-based RNG keys off global (pixel, sample), so
    tile ownership is free to change); the samples-axis extent and
    chunk size must match, because each samples-group owns a disjoint
    sample range and "completed chunks" is only meaningful for the same
    split — validated against the checkpoint, mismatches restart.
    Resume is bitwise identical to an uninterrupted run.  This is the
    elastic-recovery slot of SURVEY §5 (the reference loses the whole
    frame on any crash, main.rs panics).
    """
    import dataclasses

    import jax.numpy as jnp

    from rust_pathtracer_tpu.integrator import TraceStats
    from rust_pathtracer_tpu.parallel.shard import ShardedChunkPlan

    # resolve cascade_schedule="auto" exactly like render_radiance_sharded:
    # a chunk-0 calibration run on the plain path (worst-shard pmax
    # occupancy -> per-shard widths).  The calibration is deterministic
    # for a given (scene, cam, settings, key), so a resumed run derives
    # the IDENTICAL schedule and resume stays bitwise-exact (the
    # calibration chunk's radiance is discarded — it only measures).
    plan_plain = None
    if settings.cascade_schedule == "auto" and not settings.differentiable:
        from rust_pathtracer_tpu.render import (
            AUTO_MARGIN,
            _derive_cascade_schedule,
        )

        plain = dataclasses.replace(settings, cascade=False,
                                    cascade_schedule=None)
        plan_plain = ShardedChunkPlan(scene, cam, plain, key, mesh)
        sched = None
        if plan_plain.n_chunks > 1:
            *_unused, om0 = plan_plain.run_chunk(0)
            sched = _derive_cascade_schedule(
                np.asarray(om0), plan_plain.lanes_per_shard,
                settings.max_bounces, margin=AUTO_MARGIN,
            )
        settings = dataclasses.replace(
            settings, cascade=sched is not None, cascade_schedule=sched
        )

    plan = ShardedChunkPlan(scene, cam, settings, key, mesh)
    spp = settings.samples_per_pixel
    npix = settings.width * settings.height
    key_data = np.asarray(key)

    start_chunk = 0
    acc_host = np.zeros((npix, 3), np.float32)
    segments = 0.0
    ckpt = load_checkpoint(checkpoint_path)
    if ckpt is not None:
        matches = (
            ckpt.width == settings.width
            and ckpt.height == settings.height
            and ckpt.spp_total == spp
            and np.array_equal(ckpt.key_data, key_data)
            and ckpt.samples_axis == plan.n_samples_axis
            and ckpt.chunk == plan.chunk
        )
        if matches:
            # samples_done counts per-samples-group chunks of plan.chunk
            start_chunk = ckpt.samples_done // plan.chunk
            acc_host = np.asarray(ckpt.acc, np.float32)
            segments = ckpt.segments

    # fold the restored sums INTO the running accumulator (rather than
    # adding them at the end) so the f32 summation order matches an
    # uninterrupted run exactly -> bitwise-identical resume
    acc = jnp.asarray(acc_host)
    for c in range(start_chunk, plan.n_chunks):
        a, s, _b, o, _om = plan.run_chunk(c)
        if plan.cascade_stages and float(o[-1]) > 0.0:
            if plan_plain is not None:
                # auto-derived schedule: the renderer owns the recovery
                # — re-render this chunk on the always-exact plain path
                # (deterministic per chunk, so resume stays bitwise)
                a, s, _b, o, _om = plan_plain.run_chunk(c)
            else:
                from rust_pathtracer_tpu.render import CascadeOverflowError

                raise CascadeOverflowError(
                    f"sharded static cascade schedule "
                    f"{settings.cascade_schedule!r} dropped "
                    f"{float(o[-1]):.0f} live lanes in chunk {c}: the "
                    "image is biased.  Widen the schedule."
                )
        acc = acc + a[:npix]
        segments += float(s)
        if (c + 1 - start_chunk) % checkpoint_every == 0:
            save_checkpoint(
                checkpoint_path,
                RenderCheckpoint(
                    acc=np.asarray(acc),
                    samples_done=(c + 1) * plan.chunk,
                    width=settings.width,
                    height=settings.height,
                    spp_total=spp,
                    key_data=key_data,
                    segments=segments,
                    samples_axis=plan.n_samples_axis,
                    chunk=plan.chunk,
                ),
            )

    img = (np.asarray(acc) / np.float32(spp)).reshape(
        settings.height, settings.width, 3
    )
    from rust_pathtracer_tpu.integrator import MAX_BOUNCE_STATS

    return jnp.asarray(img), TraceStats(
        segments=jnp.float32(segments),
        bounces=jnp.int32(0),
        occupancy=jnp.zeros((MAX_BOUNCE_STATS,), jnp.float32),
    )

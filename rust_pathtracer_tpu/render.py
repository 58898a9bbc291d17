"""Render orchestration: pixel grid -> ray wavefronts -> image.

Maps the reference renderer (renderer.rs:5-37) onto accelerator
execution:

* the nested rayon par_iter over rows x cols becomes one flat lane axis
  (all pixels x a chunk of samples) traced as a single wavefront;
* the sequential per-pixel spp loop becomes sample *chunks*: each chunk
  is one jitted device program; the accumulator stays on device;
* jitter u = (x + xi)/(w-1), v = (y + xi)/(h-1) (renderer.rs:22-25);
  rows are emitted top-to-bottom, i.e. image row r is y = height-1-r
  (renderer.rs:16 iterates y in reverse);
* pixel value = sqrt(mean) — gamma 2.0 (renderer.rs:30-31).

``render_radiance`` is fully differentiable w.r.t. scene arrays, camera
parameters, and the background color.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rust_pathtracer_tpu import sampling
from rust_pathtracer_tpu.camera import Camera, camera_rays
from rust_pathtracer_tpu.integrator import TraceStats, trace


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """ImageSettings (scene.rs:19-25)."""

    width: int
    height: int
    samples_per_pixel: int
    max_bounces: int
    background: Tuple[float, float, float]
    # wavefront sizing: lanes per chunk = width * height * spp_chunk
    spp_chunk: Optional[int] = None
    # optional russian roulette start bounce (None = off, reference behavior)
    russian_roulette_start: Optional[int] = None
    # use the reverse-differentiable scan loop (fixed trip count)
    differentiable: bool = False
    # residual policy for the diff scan: None = "auto" (save
    # everything while residuals fit, then "mid"); "none"/"mid"/
    # "names" force a policy (DESIGN.md §10).  Plumbed as a static
    # jit argument so changing it actually retraces (the RPT_REMAT
    # env fallback is read at trace time and is invisible to a
    # same-shape second call)
    remat: Optional[str] = None
    # compact the wavefront after CASCADE_B1 bounces (estimator-exact;
    # see _render_chunk_cascaded).  RPT_CASCADE=1 forces it on.
    cascade: bool = False
    # static cascade schedule "boundary:shrink,..." (e.g. "5:8"): the
    # compacted width is fixed at R/shrink so NO mid-chunk host sync
    # happens (no int(n_alive) fetch + re-dispatch per boundary).
    # Live lanes that would
    # fall past a slice are counted in TraceStats.occupancy[-1] and
    # MUST be zero for the result to be unbiased — pick shrinks with
    # >=2x occupancy margin; bench tools assert it.  "auto" renders
    # chunk 0 on the plain path and derives the schedule from its
    # occupancy histogram (_derive_cascade_schedule, 2.5x margin).
    # Setting a schedule implies cascade=True.  RPT_CASCADE_STATIC
    # overrides.  The mesh-sharded renderer (parallel/shard.py)
    # honors EXPLICIT schedules per shard; dynamic boundaries and
    # "auto" calibration are single-chip-only (it warns and renders
    # the plain path).
    cascade_schedule: Optional[str] = None

    # Default wavefront sizing: ~1M lanes per chunk (set on a 16 GB
    # TPU, where 4M-lane chunks overflowed device memory; not yet
    # measured on the card).
    def resolve_chunk(self, target_lanes: int = 1 << 20) -> int:
        if self.spp_chunk is not None:
            return max(1, min(self.spp_chunk, self.samples_per_pixel))
        per_sample = self.width * self.height
        return max(1, min(self.samples_per_pixel, target_lanes // max(per_sample, 1)))


@dataclasses.dataclass(frozen=True)
class OutputSettings:
    """OutputSettings (scene.rs:27-36): one static frame, or fps*duration
    animation frames with the camera sampled at t = frame/frames
    (main.rs:51-53)."""

    image: RenderSettings
    fps: float = 0.0
    duration: float = 0.0

    @property
    def is_animation(self) -> bool:
        return self.fps > 0.0 and self.duration > 0.0

    @property
    def num_frames(self) -> int:
        return int(self.fps * self.duration) if self.is_animation else 1


def trace_pixel_lanes(
    scene,
    cam: Camera,
    base_key,
    pix,
    sample_offset,
    background,
    *,
    width: int,
    height: int,
    spp_chunk: int,
    spp_total: int,
    max_bounces: int,
    rr_start: Optional[int],
    differentiable: bool = False,
    cascade_stages=None,
    remat: Optional[str] = None,
):
    """Trace len(pix)*spp_chunk lanes for the given pixel ids.

    Shared by the single-chip chunk loop and the shard_map tile path
    (parallel/shard.py) — pixel ids are data, so a device can own any
    tile of the image.  ``cascade_stages``: static ((boundary, width),
    ...) routes the nondiff trace through the shard-local static
    cascade (integrator.trace_cascaded_static).  Returns
    (sum_radiance (len(pix), 3), stats).
    """
    npix = pix.shape[0]
    lkeys, o, d, in_range = _make_lanes(
        cam, base_key, pix, sample_offset, width=width, height=height,
        spp_chunk=spp_chunk, spp_total=spp_total,
    )

    if cascade_stages and not differentiable:
        from rust_pathtracer_tpu.integrator import trace_cascaded_static

        rad, stats = trace_cascaded_static(
            scene, o, d, in_range, lkeys, background, max_bounces,
            tuple(cascade_stages), russian_roulette_start=rr_start,
        )
        return rad.reshape(npix, spp_chunk, 3).sum(axis=1), stats

    rad, stats = trace(
        scene,
        o,
        d,
        lkeys,
        background,
        max_bounces=max_bounces,
        russian_roulette_start=rr_start,
        differentiable=differentiable,
        remat=remat,
    )

    # mask samples beyond spp_total (padded final chunk)
    rad = rad * in_range.astype(jnp.float32)[:, None]
    return rad.reshape(npix, spp_chunk, 3).sum(axis=1), stats


def _make_lanes(cam, base_key, pix, sample_offset, *, width, height,
                spp_chunk, spp_total):
    """Camera lanes for len(pix)*spp_chunk (pixel, sample) items.

    Returns (lane keys (R, 2), origins, directions, in_range (R,)
    bool — False for the padded samples of the final chunk).
    """
    col = (pix % width).astype(jnp.float32)
    row = pix // width
    y = (height - 1 - row).astype(jnp.float32)  # renderer.rs:16: reversed rows

    # np (host) constants: avoid eager device arrays during tracing
    s_local = np.arange(spp_chunk, dtype=np.uint32)
    # lane counter = pixel * spp_total + sample  -> layout-invariant RNG:
    # the same (pixel, sample) draws the same numbers no matter how the
    # work is chunked or sharded.  spp_total may be traced (dynamic) —
    # keeping it out of the compile key lets one compiled integrator
    # serve every sample count.
    spp_total = jnp.uint32(spp_total)
    counters = (
        pix[:, None] * spp_total + (sample_offset + s_local)[None, :]
    ).reshape(-1)
    lkeys = sampling.lane_keys(base_key, counters)

    jit_u = sampling.uniform2(
        sampling.bounce_keys(lkeys, 0, sampling.P_PIXEL_JITTER)
    )
    x_l = jnp.repeat(col, spp_chunk)
    y_l = jnp.repeat(y, spp_chunk)
    u = (x_l + jit_u[:, 0]) / (width - 1.0)   # renderer.rs:23
    v = (y_l + jit_u[:, 1]) / (height - 1.0)  # renderer.rs:24

    lens_keys = sampling.bounce_keys(lkeys, 0, sampling.P_LENS)
    o, d = camera_rays(cam, u, v, lens_keys)
    sample_ids = jnp.broadcast_to(
        (sample_offset + s_local)[None, :].astype(jnp.uint32),
        (pix.shape[0], spp_chunk),
    ).reshape(-1)
    in_range = sample_ids < spp_total
    return lkeys, o, d, in_range


# Chunk-loop accumulator with BUFFER DONATION: the loop carry `acc`
# has no other live reference in _render_frame, so XLA reuses its
# buffer in place instead of allocating a fresh (npix, 3) array per
# chunk (SURVEY §5 race/sanitizer slot: donation+aliasing is the JAX
# analog of the reference's ownership guarantees — tests/
# test_donation.py asserts the donated input is actually consumed and
# that results are bitwise unchanged).  NOT used by the checkpointed
# loop (utils/checkpoint.py): its overflow-recovery rollback keeps
# `acc_save` referencing an older accumulator, and donation deletes
# the underlying buffer regardless of outstanding Python references.
_accumulate = jax.jit(lambda acc, part: acc + part, donate_argnums=(0,))


@partial(
    jax.jit,
    static_argnames=(
        "width", "height", "spp_chunk", "max_bounces", "rr_start",
        "differentiable", "remat",
    ),
)
def _render_chunk(
    scene,
    cam: Camera,
    base_key,
    sample_offset,
    background,
    *,
    width: int,
    height: int,
    spp_chunk: int,
    spp_total: int,
    max_bounces: int,
    rr_start: Optional[int],
    differentiable: bool,
    remat: Optional[str] = None,
):
    """Trace width*height*spp_chunk lanes; returns (sum_radiance (H*W,3), stats)."""
    pix = np.arange(width * height, dtype=np.uint32)
    return trace_pixel_lanes(
        scene,
        cam,
        base_key,
        pix,
        sample_offset,
        background,
        width=width,
        height=height,
        spp_chunk=spp_chunk,
        spp_total=spp_total,
        max_bounces=max_bounces,
        rr_start=rr_start,
        differentiable=differentiable,
        remat=remat,
    )


# ---------------------------------------------------------------------------
# Cascade renderer: compact the wavefront once occupancy collapses.
#
# The chunked while_loop pays every per-bounce cost at the FULL lane
# count for all max_bounces iterations even when mean path depth is
# ~3 (SphereField: 20 iterations at 0.92M lanes for 2.9 mean depth).
# The cascade runs the first bounces at full width, sorts live lanes
# to the front, accumulates finished lanes' radiance,
# and resumes the remaining bounces on a narrow slice.  Per-lane
# radiance is bitwise UNCHANGED (RNG folds on carried lane keys +
# global bounce index); only the f32 accumulation order into the
# image differs from the plain chunked path.  Estimator-exact.
#
# Three variants (DESIGN.md §11):
#  * dynamic (below): slice sized by a fetched live count — one host
#    sync per boundary;
#  * static (RenderSettings.cascade_schedule "5:8,9:64"): fixed
#    widths, whole chunk in ONE jit, overflow guard in occupancy[-1];
#    the lane-level loop lives in integrator.trace_cascaded_static
#    and also runs per shard under shard_map (parallel/shard.py);
#  * "auto": chunk 0 calibrates the static schedule from its
#    occupancy histogram (_derive_cascade_schedule).
# Opt-in via RenderSettings.cascade / cascade_schedule / RPT_CASCADE.
# ---------------------------------------------------------------------------

CASCADE_B1 = 3
_CASCADE_SHRINKS = (32, 16, 8, 4, 2, 1)

# auto-schedule derivation: slice widths hug AUTO_MARGIN x the probed
# live count; the probe renders ~AUTO_PROBE_TARGET strided pixels at
# 1 spp on the plain path (cheap vs a full-width calibration chunk).
# The margin can sit near 1 because render_radiance owns the overflow
# guard (re-derive at doubled margin + re-render).
AUTO_MARGIN = 1.35
AUTO_PROBE_TARGET = 1 << 16


class CascadeOverflowError(RuntimeError):
    """A static cascade slice dropped live lanes (occupancy[-1] > 0):
    the rendered image is silently DARKENED by the missing paths.
    Widen the schedule (smaller shrinks / later boundaries) or use
    cascade_schedule="auto", which derives safe widths and auto-widens
    on overflow."""


@partial(
    jax.jit,
    static_argnames=("width", "height", "spp_chunk"),
)
def _cascade_spawn(scene, cam, base_key, sample_offset, *,
                   width, height, spp_chunk, spp_total):
    """Camera lanes in the packed cascade-state layout, plus the
    full-width ``banked`` radiance / ``lane`` caller-index arrays that
    ride every subsequent reordering (see _cascade_stage)."""
    npix = width * height
    pix = np.arange(npix, dtype=np.uint32)
    lkeys, o, d, alive = _make_lanes(
        cam, base_key, pix, sample_offset, width=width, height=height,
        spp_chunk=spp_chunk, spp_total=spp_total,
    )
    R = o.shape[0]
    packed = dict(
        o=o, d=d,
        thr=jnp.ones((R, 3), jnp.float32),
        rad=jnp.zeros((R, 3), jnp.float32),
        alive=alive, lkeys=lkeys,
    )
    banked = jnp.zeros((R, 3), jnp.float32)
    lane = jnp.arange(R, dtype=jnp.int32)
    return packed, banked, lane


@partial(jax.jit, static_argnames=("b0", "b1", "rr_start", "final",
                                   "spp_chunk"))
def _cascade_stage(scene, packed, background, banked, lane, *, b0, b1,
                   rr_start, final, spp_chunk):
    """Bounces [b0, b1) on the packed lanes (width W <= full R).

    ``banked`` (R, 3) and ``lane`` (R,) ride the wavefront ordering:
    slot i holds the radiance banked so far by / the caller index of
    the lane that currently (or last, if sliced away) occupied
    position i.  Finished lanes flush DENSELY into banked[:W]; a
    boundary sorts live lanes to the front and permutes banked/lane
    alongside.  The final stage unscrambles with ONE key/value sort +
    reshape-sum.  There is no scatter at any width.
    """
    from rust_pathtracer_tpu.integrator import trace_resume

    state, b_done = trace_resume(
        scene, packed["o"], packed["d"], packed["thr"], packed["rad"],
        packed["alive"], packed["lkeys"], background, b0, b1,
        russian_roulette_start=rr_start,
    )
    W = packed["o"].shape[0]
    if final:
        banked = banked.at[:W].add(state["rad"])
        _, r0, r1, r2 = jax.lax.sort(
            (lane, banked[:, 0], banked[:, 1], banked[:, 2]), num_keys=1
        )
        R = banked.shape[0]
        acc = jnp.stack([r0, r1, r2], axis=1).reshape(
            R // spp_chunk, spp_chunk, 3
        ).sum(axis=1)
        return acc, state["segments"], b_done, state["occupancy"]
    alive = state["alive"]
    banked = banked.at[:W].add(
        jnp.where(alive[:, None], 0.0, state["rad"])
    )
    skey = jnp.where(alive, 0, np.int32(2 ** 30))
    # ONE carried sort, not perm + per-array gathers (see
    # integrator.sort_carry).  sort_carry's iota tie-break key
    # reproduces the stable permutation exactly (ties are common:
    # every dead lane shares one key), so the fused one-jit chunk
    # still matches the stage-per-jit pipeline bitwise.
    from rust_pathtracer_tpu.integrator import sort_carry

    rad_m = jnp.where(alive[:, None], state["rad"], 0.0)
    (o_s, d_s, thr_s, rad_s, alive_s, lkeys_s, bank_s, lane_s) = sort_carry(
        (skey,),
        [state["o"], state["d"], state["thr"], rad_m, alive,
         packed["lkeys"], banked[:W], lane[:W]],
    )
    out = dict(o=o_s, d=d_s, thr=thr_s, rad=rad_s, alive=alive_s,
               lkeys=lkeys_s)
    # concatenate, do NOT x.at[:W].set(x[:W][perm]): the self-referencing
    # update miscompiled inside a fused jit (lane stopped being a
    # permutation; XLA in-place DUS + gather aliasing hazard)
    banked = jnp.concatenate([bank_s, banked[W:]], axis=0)
    lane = jnp.concatenate([lane_s, lane[W:]], axis=0)
    n_alive = jnp.sum(alive.astype(jnp.int32))
    return (out, banked, lane, n_alive, state["segments"], b_done,
            state["occupancy"])


def _cascade_boundaries(max_bounces):
    import os

    raw = os.environ.get("RPT_CASCADE_B1")
    if raw:
        bs = [int(x) for x in raw.split(",")]
    else:
        bs = [CASCADE_B1]
    return [b for b in sorted(set(bs)) if 0 < b < max_bounces]


def parse_cascade_schedule(raw):
    """Parse a "b:s,b:s" schedule string into [(boundary, shrink)].

    ``shrink`` is an integer divisor or a rational "num/den" (e.g.
    "1:16/11" keeps 11/16 of the lanes — fractional occupancies like
    ModelTest's 59%-alive bounce 1 don't fit power-of-two divisors;
    the boundary's sort is paid either way, so the slice should hug
    the live count).  Returned shrinks are Fractions; boundaries and
    shrinks must both strictly increase.

    Raises ValueError with a readable message on malformed input —
    the CLI validates at argument-parse time with this; the renderer
    helpers catch and fall back.
    """
    from fractions import Fraction

    out = []
    prev_b, prev_s = 0, Fraction(0)
    for part in raw.split(","):
        try:
            b_str, s_str = part.split(":")
            b = int(b_str)
            if "/" in s_str:
                num, den = s_str.split("/")
                s = Fraction(int(num), int(den))
            else:
                s = Fraction(int(s_str))
        except (ValueError, ZeroDivisionError):
            raise ValueError(
                f"cascade schedule entry {part!r} is not 'bounce:shrink' "
                "(shrink: int or num/den)"
            ) from None
        if s < 1:
            raise ValueError(
                f"cascade shrink must be >= 1, got {part!r}"
            )
        if b <= prev_b:
            raise ValueError(
                f"cascade boundaries must increase, got {raw!r}"
            )
        if s <= prev_s:
            raise ValueError(
                f"cascade shrinks must increase, got {raw!r}"
            )
        out.append((b, s))
        prev_b, prev_s = b, s
    return out


def _cascade_static_schedule(max_bounces, n_lanes, settings_schedule=None):
    """Resolve "5:8,9:16" -> [(boundary, static width)] (see
    RenderSettings.cascade_schedule).  Returns [] when unset,
    malformed, or inapplicable to this lane count / bounce limit
    (falls back to the dynamic host-synced cascade)."""
    import os

    raw = os.environ.get("RPT_CASCADE_STATIC") or settings_schedule
    if not raw:
        return []
    from rust_pathtracer_tpu.integrator import MAX_BOUNCE_STATS

    if max_bounces >= MAX_BOUNCE_STATS - 1:
        # the occupancy[-1] overflow guard would alias a real bounce
        # slot — fall back to the dynamic host-synced cascade
        return []
    try:
        pairs = parse_cascade_schedule(raw)
    except ValueError:
        return []
    out = []
    for b, shrink in pairs:
        # exact width only (shrink is a Fraction): predictable slices,
        # and integer divisors keep their historical widths bit-for-bit
        num, den = shrink.numerator, shrink.denominator
        if not (b < max_bounces and (n_lanes * den) % num == 0
                and (n_lanes * den) // num >= 1):
            return []
        out.append((b, (n_lanes * den) // num))
    return out


@partial(jax.jit, static_argnames=("width", "height", "spp_chunk",
                                   "max_bounces", "rr_start", "stages"))
def _render_chunk_cascaded_static(scene, cam, base_key, sample_offset, bg,
                                  *, width, height, spp_chunk, spp_total,
                                  max_bounces, rr_start, stages):
    """The whole static-schedule cascade chunk as ONE jit: spawn,
    full-width stage, per-boundary sort/slice at the fixed widths,
    compacted tails, final sort-unscramble.  Zero host syncs and zero
    inter-stage dispatch gaps.  ``stages`` is a
    static tuple of (boundary, width); the lane-level cascade itself
    lives in integrator.trace_cascaded_static (shared with the
    mesh-sharded renderer)."""
    from rust_pathtracer_tpu.integrator import trace_cascaded_static

    npix = width * height
    pix = np.arange(npix, dtype=np.uint32)
    lkeys, o, d, alive = _make_lanes(
        cam, base_key, pix, sample_offset, width=width, height=height,
        spp_chunk=spp_chunk, spp_total=spp_total,
    )
    rad, stats = trace_cascaded_static(
        scene, o, d, alive, lkeys, bg, max_bounces, stages,
        russian_roulette_start=rr_start,
    )
    acc = rad.reshape(npix, spp_chunk, 3).sum(axis=1)
    return acc, stats


def _derive_cascade_schedule(occupancy, n_lanes, max_bounces, *,
                             margin=AUTO_MARGIN, max_stages=4):
    """Static cascade schedule from a measured occupancy histogram.

    ``occupancy[b]`` = lanes alive entering bounce b (one chunk).  For
    each candidate boundary the slice width hugs ``margin`` x the
    measured live count exactly (rounded up to a 128-lane multiple —
    keeps widths aligned to whole 128-lane tiles; shrinks are emitted
    as rationals, see parse_cascade_schedule).  The emit rules mirror what the measured-
    best hand schedules look like (DESIGN.md §11: ModelTest
    "1:1,2:8,3:16,4:32,5:256", SphereField "2:2,3:3,4:5,5:10,9:80"):
    the first boundary lands when the width drops to <= 60% of the
    pool (a near-full-width slice materialization costs more than the
    shrink saves — the measured-negative b1 experiments), then a new
    boundary whenever the width drops another >=1.4x (carried-sort
    boundaries are cheap at compacted widths), up to ``max_stages``
    (capped low: each boundary inflates the one-jit cascade graph and
    its compile time).
    Returns a "b:s,b:s" string or None when no boundary pays.

    ``margin`` (default AUTO_MARGIN) can sit close to 1: the renderer
    OWNS the overflow guard (render_radiance re-derives at a doubled
    margin and re-renders on occupancy[-1] > 0), so a tight schedule
    can never silently bias — chunk-to-chunk occupancy varies only by
    sampling noise at >=1e5 lanes.
    """
    from fractions import Fraction

    nb = min(int(max_bounces), len(occupancy) - 1)
    stages = []
    cur = n_lanes
    for b in range(1, nb):
        alive = float(occupancy[b])
        w = int(-(-max(margin * alive, 128.0) // 128.0) * 128)
        emit = w <= (0.6 * n_lanes if not stages else cur / 1.4)
        if emit and len(stages) < max_stages:
            f = Fraction(n_lanes, w)
            s = (str(f.numerator) if f.denominator == 1
                 else f"{f.numerator}/{f.denominator}")
            stages.append(f"{b}:{s}")
            cur = w
    return ",".join(stages) if stages else None


@partial(jax.jit, static_argnames=("width", "height", "max_bounces",
                                   "rr_start"))
def _probe_chunk(scene, cam, base_key, pix, bg, *, width, height,
                 spp_total, max_bounces, rr_start):
    """Plain 1-spp trace over a strided pixel subset — the cheap
    occupancy probe behind cascade_schedule="auto"."""
    return trace_pixel_lanes(
        scene, cam, base_key, pix, jnp.uint32(0), bg,
        width=width, height=height, spp_chunk=1, spp_total=spp_total,
        max_bounces=max_bounces, rr_start=rr_start, differentiable=False,
    )


def derive_cascade_schedule(scene, cam, settings, key, background=None,
                            *, margin=AUTO_MARGIN):
    """Derive a static cascade schedule from a cheap probe render.

    Renders ~AUTO_PROBE_TARGET strided pixels at 1 spp on the plain
    path, scales the measured occupancy histogram to the full chunk
    lane count, and derives margin-hugging 128-aligned widths
    (_derive_cascade_schedule).  Deterministic for a given (scene, camera, settings, key)
    — a resumed or repeated render derives the identical schedule.
    Returns a schedule string or None when no boundary pays.

    Animation callers should derive ONCE and pass the string as an
    explicit schedule: every distinct schedule string is a separate
    compiled cascade graph, so a per-frame re-derivation that wobbles
    a width would recompile.
    """
    return derive_cascade_schedule_multi(
        scene, [cam], settings, key, background, margin=margin
    )


def derive_cascade_schedule_multi(scene, cams, settings, key,
                                  background=None, *, margin=AUTO_MARGIN):
    """Orbit-robust schedule: one probe per camera pose, max envelope.

    Animations pin ONE schedule across every frame (each distinct
    schedule string is a fresh cascade compile), but a schedule
    derived from frame 0 alone can go stale as the camera orbits.
    Probing N poses across the orbit
    and deriving from the per-bounce MAX of their occupancy histograms
    makes the pinned schedule cover the whole path the probes saw; the
    renderer's overflow guard still protects the poses in between.
    All poses share one compiled probe graph (same shapes).
    """
    if not cams:
        raise ValueError(
            "derive_cascade_schedule_multi: need at least one camera "
            "pose to probe (got an empty cams list)"
        )
    bg = jnp.asarray(
        settings.background if background is None else background,
        jnp.float32,
    )
    chunk = settings.resolve_chunk()
    npix = settings.width * settings.height
    stride = max(1, npix // AUTO_PROBE_TARGET)
    pix = np.arange(0, npix, stride, dtype=np.uint32)
    # spp_total=1: the probe's RNG counters must NOT depend on the
    # render's sample count, or two renders of the same scene at
    # different spp derive (slightly) different schedules — each
    # distinct schedule string is a fresh cascade compile (a warm pass
    # at chunk-spp and a timed pass at full spp would not share one)
    occ = None
    for cam in cams:
        _, stats = _probe_chunk(
            scene, cam, key, pix, bg,
            width=settings.width, height=settings.height,
            spp_total=1,
            max_bounces=settings.max_bounces,
            rr_start=settings.russian_roulette_start,
        )
        o = np.asarray(stats.occupancy)
        occ = o if occ is None else np.maximum(occ, o)
    n_lanes = npix * chunk
    scale = n_lanes / float(pix.shape[0])
    sched = _derive_cascade_schedule(
        occ * scale, n_lanes, settings.max_bounces, margin=margin
    )
    return sched


def _render_chunk_cascaded(scene, cam, base_key, sample_offset, bg, *,
                           width, height, spp_chunk, spp_total,
                           max_bounces, rr_start, schedule=None):
    """One spp chunk through the staged cascade.

    Dynamic mode (default): the host sizes each continuation from the
    fetched live count — one scalar sync per boundary.  RPT_CASCADE_B1 sets the boundaries
    (comma-separated, e.g. "2,5").

    Static mode (``schedule``/RPT_CASCADE_STATIC "5:8,..."): widths
    are fixed, no sync at all; live lanes that would fall past a
    slice are counted into occupancy[-1] (must be zero — see
    RenderSettings.cascade_schedule)."""
    R_full = width * height * spp_chunk
    static_stages = _cascade_static_schedule(max_bounces, R_full, schedule)
    if static_stages:
        return _render_chunk_cascaded_static(
            scene, cam, base_key, sample_offset, bg,
            width=width, height=height, spp_chunk=spp_chunk,
            spp_total=spp_total, max_bounces=max_bounces,
            rr_start=rr_start, stages=tuple(static_stages),
        )
    packed, banked, lane = _cascade_spawn(
        scene, cam, base_key, sample_offset,
        width=width, height=height, spp_chunk=spp_chunk,
        spp_total=spp_total,
    )
    boundaries = _cascade_boundaries(max_bounces)
    segs = jnp.float32(0.0)
    bounces = jnp.int32(0)
    occ = None
    b0 = 0
    for b1 in boundaries:
        packed, banked, lane, n_alive, s1, bd, oc = _cascade_stage(
            scene, packed, bg, banked, lane, b0=b0, b1=b1,
            rr_start=rr_start, final=False, spp_chunk=spp_chunk,
        )
        segs, bounces = segs + s1, bounces + bd
        occ = oc if occ is None else occ + oc
        n = int(n_alive)  # host sync: sizes the compacted continuation
        R = packed["o"].shape[0]
        S = R
        for f in _CASCADE_SHRINKS:
            if R // f >= max(n, 128) and (R // f) * f == R:
                S = R // f
                break
        packed = {k: v[:S] for k, v in packed.items()}
        b0 = b1
    acc, s1, bd, oc = _cascade_stage(
        scene, packed, bg, banked, lane, b0=b0, b1=max_bounces,
        rr_start=rr_start, final=True, spp_chunk=spp_chunk,
    )
    segs, bounces = segs + s1, bounces + bd
    occ = oc if occ is None else occ + oc
    return acc, TraceStats(segments=segs, bounces=bounces, occupancy=occ)


def _render_frame(scene, cam, settings, key, bg, spp, chunk, *,
                  cascade, schedule):
    """One full frame at a RESOLVED schedule (no "auto" here).

    Returns (img, stats, used_static) — used_static says whether the
    static cascade (the only path that can drop live lanes) actually
    applied, so the caller knows occupancy[-1] is a guard slot.
    """
    used_static = False
    if cascade:
        R_full = settings.width * settings.height * chunk
        used_static = bool(
            _cascade_static_schedule(settings.max_bounces, R_full, schedule)
        )
    acc = jnp.zeros((settings.width * settings.height, 3), jnp.float32)
    total_segments = jnp.float32(0.0)
    total_bounces = jnp.int32(0)
    total_occ = None
    for s0 in range(0, spp, chunk):
        if cascade:
            part, stats = _render_chunk_cascaded(
                scene, cam, key, jnp.uint32(s0), bg,
                width=settings.width, height=settings.height,
                spp_chunk=chunk, spp_total=spp,
                max_bounces=settings.max_bounces,
                rr_start=settings.russian_roulette_start,
                schedule=schedule,
            )
        else:
            part, stats = _render_chunk(
                scene, cam, key, jnp.uint32(s0), bg,
                width=settings.width, height=settings.height,
                spp_chunk=chunk, spp_total=spp,
                max_bounces=settings.max_bounces,
                rr_start=settings.russian_roulette_start,
                differentiable=settings.differentiable,
                remat=settings.remat,
            )
        acc = _accumulate(acc, part)
        total_segments = total_segments + stats.segments
        total_bounces = total_bounces + stats.bounces
        total_occ = (
            stats.occupancy if total_occ is None
            else total_occ + stats.occupancy
        )

    img = (acc / jnp.float32(spp)).reshape(settings.height, settings.width, 3)
    stats = TraceStats(
        segments=total_segments, bounces=total_bounces, occupancy=total_occ
    )
    return img, stats, used_static


def render_radiance(
    scene,
    cam: Camera,
    settings: RenderSettings,
    key,
    background=None,
):
    """Linear-space mean radiance image (H, W, 3) + TraceStats.

    Differentiable w.r.t. the DiffParams leaves (textures / camera /
    background) — the supported gradient surface (grad.py).  Gradients
    taken directly w.r.t. raw primitive arrays omit the hit-distance
    term under the default analytic-t path; set RPT_DIFF_T=rederive
    for full geometry gradients (integrator._analytic_t).

    Static-cascade safety: the renderer OWNS the overflow guard.  With
    an explicit schedule, any dropped live lane (occupancy[-1] > 0)
    raises CascadeOverflowError instead of returning a silently
    darkened image.  With "auto" the schedule is derived from a cheap
    probe render (derive_cascade_schedule) and on overflow the frame
    is re-derived at double the margin and re-rendered (twice, then
    the plain path) — the renderer chose the widths, so it owns the
    recovery.  One occupancy fetch per frame; no per-chunk syncs.
    """
    spp = settings.samples_per_pixel
    chunk = settings.resolve_chunk()
    bg = jnp.asarray(
        settings.background if background is None else background, jnp.float32
    )

    import os
    import warnings

    cascade = (
        settings.cascade
        or os.environ.get("RPT_CASCADE", "0") == "1"
        or settings.cascade_schedule is not None
    ) and not settings.differentiable
    auto = cascade and settings.cascade_schedule == "auto"
    margin = AUTO_MARGIN
    max_attempts = 3 if auto else 1

    for attempt in range(max_attempts):
        if auto:
            sched = derive_cascade_schedule(
                scene, cam, settings, key, background, margin=margin
            )
            use_cascade = sched is not None
        else:
            sched = settings.cascade_schedule
            use_cascade = cascade
        img, stats, used_static = _render_frame(
            scene, cam, settings, key, bg, spp, chunk,
            cascade=use_cascade, schedule=sched,
        )
        if not used_static or isinstance(stats.occupancy, jax.core.Tracer):
            return img, stats
        overflow = float(stats.occupancy[-1])
        if overflow == 0.0:
            return img, stats
        if not auto:
            raise CascadeOverflowError(
                f"static cascade schedule {sched!r} dropped "
                f"{overflow:.0f} live lanes (occupancy[-1] > 0): the "
                "image is biased.  Widen the schedule or use "
                "cascade_schedule='auto'."
            )
        warnings.warn(
            f"auto cascade schedule {sched!r} dropped {overflow:.0f} "
            f"live lanes — re-deriving at margin {margin * 2:g} and "
            "re-rendering",
            stacklevel=2,
        )
        margin *= 2.0

    # auto attempts exhausted: the plain chunked path is always exact
    warnings.warn(
        "auto cascade schedule still overflowed after widening — "
        "rendering the plain chunked path",
        stacklevel=2,
    )
    img, stats, _ = _render_frame(
        scene, cam, settings, key, bg, spp, chunk,
        cascade=False, schedule=None,
    )
    return img, stats


def render_image(scene, cam: Camera, settings: RenderSettings, key):
    """Render to gamma-2 RGB8, like renderer.rs:30-33 + vec3.rs:278-291."""
    from rust_pathtracer_tpu.utils.image import to_rgb8

    img, stats = render_radiance(scene, cam, settings, key)
    return to_rgb8(np.asarray(img)), stats

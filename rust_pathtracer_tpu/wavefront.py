"""Regeneration wavefront renderer (path-regeneration queues).

The chunked renderer (render.py) traces width*height*spp_chunk lanes in
lockstep until ALL of them die: in deep-bounce scenes with a black
background (LightTest: max 50 bounces, measured occupancy 5% after two
bounces) the tail wastes >90% of the vector unit.

This renderer is a static-shape version of "stream-compacted bounce
queues": a fixed pool of lanes stays highly occupied because a
lane that terminates is REFILLED with the next (pixel, sample) item
from the global work queue — static shapes, no scatter/compact of live
state, just an exclusive cumsum to hand out fresh work ids and one
scatter-add to flush finished radiance into the per-pixel accumulator.

AMORTIZED FLUSH: flushing + refilling every iteration pays the refill
machinery (camera-ray spawn + RNG chains + cumsum + scatter-add) on
every lane every iteration.  The loop runs ``flush_every`` bounce
iterations between flushes: finished lanes hold their radiance
(alive=False, work id kept) until the window ends, so the refill
machinery runs 1/K as often at the cost of those lanes idling for at
most K-1 iterations.  K=2 is the default (set on a 16 GB TPU; not yet
measured on the card).

RNG consistency: a work item's lane key is derived from the same
(pixel * spp + sample) counter and per-(bounce, purpose) fold as the
chunked renderer, and each lane tracks its own path depth — so every
path computes the SAME radiance in either mode; only the f32
accumulation order differs (images agree to ~1e-6).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from rust_pathtracer_tpu import sampling
from rust_pathtracer_tpu import vecmath as vm
from rust_pathtracer_tpu.camera import Camera, camera_rays
from rust_pathtracer_tpu.integrator import (
    MAX_BOUNCE_STATS,
    TraceStats,
    search_and_record,
)
from rust_pathtracer_tpu.materials import emitted, scatter, shade_inputs
from rust_pathtracer_tpu.render import RenderSettings


def _stripe_len(total: int, spp: int, lanes: int):
    """Pixel-aligned stripe length for the stripe-queue mode: the
    smallest divisor of spp >= ceil(total/lanes), or None when no
    single-pixel stripe covers the pool (lanes < npix)."""
    k0 = -(-total // lanes)
    if k0 > spp:
        return None
    for k in range(k0, spp + 1):
        if spp % k == 0:
            return k
    return None


def render_radiance_regen(
    scene,
    cam: Camera,
    settings: RenderSettings,
    key,
    lanes: int | None = None,
    flush_every: int | None = None,
    mode: str | None = None,
):
    """Linear radiance image via the regeneration wavefront.

    Returns ((H, W, 3) image, TraceStats).  Equivalent estimator to
    render_radiance (same per-path RNG); accumulation order differs.
    ``flush_every``: bounce iterations between flush+refill windows
    (default 2; RPT_FLUSH_EVERY overrides).

    ``mode`` (RPT_REGEN_MODE): work-handout strategy.

    * "queue" — a global work counter; finished lanes take the next
      (pixel, sample) via an exclusive cumsum and their radiance is
      scatter-added into the image accumulator every window.
    * "stripe" — each lane OWNS a fixed pixel-aligned stripe of
      consecutive work ids (pixel-major: ids p*spp+s, so one stripe =
      one pixel's sample range).  A finished lane banks its radiance
      into a lane-local pixel sum and advances to its next sample —
      no cumsum, no per-window scatter; ONE scatter-add flushes the
      lane sums at the very end.  A documented negative: path depths
      within one pixel are strongly CORRELATED (same geometry), so a
      worst-pixel stripe drains alone for thousands of iterations (the
      iid-concentration argument only holds across pixels).  Opt-in.
    * "auto" (default) — "queue".
    """
    width, height = settings.width, settings.height
    spp = settings.samples_per_pixel
    max_bounces = settings.max_bounces
    rr_start = settings.russian_roulette_start
    npix = width * height
    total = npix * spp
    if lanes is None:
        lanes = min(total, 1 << 20)
    lanes = int(min(lanes, total))
    if lanes <= 0:
        raise ValueError(f"lane pool must be positive, got {lanes}")
    if flush_every is None:
        flush_every = int(os.environ.get("RPT_FLUSH_EVERY", 2))
    flush_every = max(1, flush_every)
    if total >= 2 ** 31:
        # work ids / the issued counter are int32 (the queue handout is
        # a cumsum over lanes); the chunked renderer handles any total
        # via uint32 (pixel, sample) counters and spp chunking
        raise ValueError(
            f"regen wavefront work queue is int32-indexed: width*height*"
            f"spp = {total} >= 2**31; use render_radiance for this size"
        )
    bg = jnp.asarray(settings.background, jnp.float32)

    mode = mode or os.environ.get("RPT_REGEN_MODE", "auto")
    if mode not in ("auto", "stripe", "queue"):
        raise ValueError(f"regen mode {mode!r}")
    stripe_k = _stripe_len(total, spp, lanes)
    if mode == "stripe" and stripe_k is None:
        raise ValueError(
            f"stripe mode needs a pixel-aligned stripe: spp={spp} has "
            f"no divisor >= ceil(total/lanes)={-(-total // lanes)}"
        )
    use_stripe = stripe_k is not None and mode == "stripe"
    if use_stripe:
        # exact pool: one lane per stripe (stripe_k | spp | total)
        lanes = total // stripe_k

    def spawn(work_id):
        """Camera rays + keys for (clipped) work ids."""
        wid = jnp.maximum(work_id, 0).astype(jnp.uint32)
        if use_stripe:
            # pixel-major ids: one stripe of consecutive ids = one
            # pixel's contiguous sample range (lane-local accumulation)
            pixel = wid // np.uint32(spp)
            sample = wid % np.uint32(spp)
        else:
            pixel = wid % np.uint32(npix)
            sample = wid // np.uint32(npix)
        counter = pixel * np.uint32(spp) + sample  # render.py convention
        lkeys = sampling.lane_keys(key, counter)
        jit_u = sampling.uniform2(
            sampling.bounce_keys(lkeys, 0, sampling.P_PIXEL_JITTER)
        )
        col = (pixel % np.uint32(width)).astype(jnp.float32)
        row = pixel // np.uint32(width)
        y = (height - 1 - row).astype(jnp.float32)
        u = (col + jit_u[:, 0]) / (width - 1.0)
        v = (y + jit_u[:, 1]) / (height - 1.0)
        lens = sampling.bounce_keys(lkeys, 0, sampling.P_LENS)
        o, d = camera_rays(cam, u, v, lens)
        return pixel.astype(jnp.int32), lkeys, o, d

    # initial fill
    if use_stripe:
        init_work = jnp.arange(lanes, dtype=jnp.int32) * np.int32(stripe_k)
    else:
        init_work = jnp.arange(lanes, dtype=jnp.int32)
    pixel0, lkeys0, o0, d0 = spawn(init_work)

    from rust_pathtracer_tpu.ops.fused_bounce import (
        fused_bounce_apply,
        fused_bounce_ok,
    )

    use_fb = fused_bounce_ok(scene)

    state = dict(
        work=init_work,                               # -1 => lane idle
        pixel=pixel0,
        lkeys=lkeys0,
        o=o0,
        d=d0,
        thr=jnp.ones((lanes, 3), jnp.float32),
        rad=jnp.zeros((lanes, 3), jnp.float32),
        depth=jnp.zeros(lanes, jnp.int32),
        alive=init_work < total,
        segments=jnp.float32(0.0),
        iters=jnp.int32(0),
        # per-path-LENGTH counts, accumulated when a lane finishes
        # (flush windows); converted to the chunked renderer's
        # per-bounce occupancy after the loop
        hist=jnp.zeros((MAX_BOUNCE_STATS,), jnp.float32),
    )
    if use_stripe:
        # nxt/send: the lane's remaining stripe [nxt, send); acc_lane:
        # the lane-local pixel sum (flushed ONCE after the loop)
        state.update(
            nxt=init_work + 1,
            send=init_work + np.int32(stripe_k),
            acc_lane=jnp.zeros((lanes, 3), jnp.float32),
        )
    else:
        state.update(
            issued=jnp.int32(lanes),
            acc=jnp.zeros((npix, 3), jnp.float32),
        )

    def _depth_hist(depth, finished):
        """Counts of finished lanes per (clamped) path length — a dense
        masked reduction, not a scatter."""
        bins = np.arange(MAX_BOUNCE_STATS, dtype=np.int32)
        d = jnp.minimum(depth, np.int32(MAX_BOUNCE_STATS - 1))
        m = (d[:, None] == bins[None, :]) & finished[:, None]
        return jnp.sum(m, axis=0).astype(jnp.float32)

    def bounce(s):
        """One bounce for the live lanes; finished lanes hold their
        radiance (alive=False, work kept) until the next flush."""
        o, d, thr, rad = s["o"], s["d"], s["thr"], s["rad"]
        alive, depth, lkeys = s["alive"], s["depth"], s["lkeys"]
        segments = s["segments"] + jnp.sum(alive.astype(jnp.float32))

        # per-lane path depth drives the RNG counter (matches chunked
        # mode: sampling.bounce_draws, same scheme both paths).
        # Uniforms only here: the fused body transforms them itself;
        # the composed branch transforms below.  Roulette's draw
        # shares the same 4 threefry blocks (packed scheme).
        sphere_u, ball_u, coin, rl_u = sampling.bounce_draws(
            lkeys, depth, rr_start is not None
        )

        depth_old = depth
        depth = depth + alive.astype(jnp.int32)
        depth_ok = depth < max_bounces
        if use_fb:
            # fused whole bounce (ops/fused_bounce.py).  The
            # fused body commits o/d/thr with its own cont (no depth cap);
            # lanes the cap kills below are dead either way and their
            # state is never read again (flush uses rad+work only,
            # respawn overwrites), so the estimator is unchanged.
            from rust_pathtracer_tpu.integrator import T_MIN

            o, d, thr, rad, cont_k = fused_bounce_apply(
                scene, o, d, thr, rad, alive, sphere_u, ball_u, coin,
                bg, T_MIN,
            )
            cont = cont_k & depth_ok
        else:
            hit_mask, rec = search_and_record(scene, o, d, alive)
            si = shade_inputs(scene, rec)

            miss = alive & ~hit_mask
            rad = rad + jnp.where(miss[..., None], thr * bg, 0.0)
            em = emitted(scene, rec, si)
            rad = rad + jnp.where(hit_mask[..., None], thr * em, 0.0)

            sphere_dir = sampling.on_unit_sphere_from_u(sphere_u)
            ball_dir = sampling.in_unit_sphere_from_u(ball_u)
            sc = scatter(scene, rec, d, sphere_dir, ball_dir, coin, si)

            cont = alive & hit_mask & sc.did_scatter & depth_ok
            thr = jnp.where(cont[..., None], thr * sc.attenuation, thr)
            o = vm.where(cont, rec.point, o)
            d = vm.where(cont, sc.direction, d)

        # Russian roulette, per-lane (depths differ in the regen pool):
        # same RNG fold (lane key, path bounce index = depth_old) and
        # same survive/compensate rule as the chunked path's roulette
        # (integrator._bounce_step), so the estimator stays identical
        if rr_start is not None:
            p = jnp.clip(jnp.max(thr, axis=-1), 0.05, 1.0)
            u = rl_u  # drawn above at bounce index depth_old == depth
            sel = cont & (depth_old >= rr_start)
            survive = u < p
            thr = jnp.where((sel & survive)[..., None],
                            thr / p[..., None], thr)
            cont = cont & (~sel | survive)

        return dict(
            s, o=o, d=d, thr=thr, rad=rad, depth=depth, alive=cont,
            segments=segments, iters=s["iters"] + 1,
        )

    # Flush variant (RPT_REGEN_FLUSH): "scatter" (plain colliding
    # scatter-add, default) or "sorted" (key/value lax.sort +
    # indices_are_sorted scatter; same result).  "none" skips
    # accumulation entirely (BIASED — for isolating the flush cost).
    flush_mode = os.environ.get("RPT_REGEN_FLUSH", "scatter")
    if flush_mode not in ("scatter", "sorted", "none"):
        raise ValueError(f"RPT_REGEN_FLUSH={flush_mode!r}")

    def flush_radiance(acc, finished, pixel, rad):
        if flush_mode == "none":
            return acc
        if flush_mode == "scatter":
            return acc.at[jnp.where(finished, pixel, 0)].add(
                jnp.where(finished[..., None], rad, 0.0)
            )
        # sorted: dead records key to npix (out of range) and are
        # dropped by the scatter; is_stable so equal-pixel records
        # accumulate in lane order on every compilation (same key ->
        # same image, cross-platform)
        pkey = jnp.where(finished, pixel, np.int32(npix))
        r = jnp.where(finished[:, None], rad, 0.0)
        pk2, r0, r1, r2 = jax.lax.sort(
            (pkey, r[:, 0], r[:, 1], r[:, 2]), num_keys=1, is_stable=True
        )
        upd = jnp.stack([r0, r1, r2], axis=1)
        return acc.at[pk2].add(upd, mode="drop", indices_are_sorted=True)

    def flush_refill(s):
        """Flush finished lanes' radiance into the accumulator and
        hand each flushed lane the next queued (pixel, sample)."""
        alive, work = s["alive"], s["work"]
        finished = ~alive & (work >= 0)
        hist = s["hist"] + _depth_hist(s["depth"], finished)
        acc = flush_radiance(s["acc"], finished, s["pixel"], s["rad"])

        issued = s["issued"]
        cand = finished.astype(jnp.int32)
        slot = jnp.cumsum(cand) - cand  # exclusive prefix sum: queue slots
        new_work = issued + slot
        take = finished & (new_work < total)
        new_work = jnp.where(take, new_work, -1)
        issued = issued + jnp.minimum(jnp.sum(cand), total - issued)

        pixel_n, lkeys_n, o_n, d_n = spawn(new_work)
        pixel = jnp.where(take, pixel_n, s["pixel"])
        lkeys = jnp.where(take[:, None], lkeys_n, s["lkeys"])
        o = vm.where(take, o_n, s["o"])
        d = vm.where(take, d_n, s["d"])
        thr = vm.where(take, jnp.ones_like(s["thr"]), s["thr"])
        rad = vm.where(take, jnp.zeros_like(s["rad"]), s["rad"])
        depth = jnp.where(take, 0, s["depth"])
        work = jnp.where(take, new_work, jnp.where(finished, -1, work))
        return dict(
            s, work=work, pixel=pixel, lkeys=lkeys, o=o, d=d, thr=thr,
            rad=rad, depth=depth, alive=s["alive"] | take, issued=issued,
            acc=acc, hist=hist,
        )

    def advance_stripe(s):
        """Bank finished lanes' radiance into their lane-local pixel
        sum and respawn them on their stripe's next sample — no queue
        cumsum, no scatter (the one image scatter runs after the
        loop)."""
        alive, work = s["alive"], s["work"]
        finished = ~alive & (work >= 0)
        hist = s["hist"] + _depth_hist(s["depth"], finished)
        acc_lane = s["acc_lane"] + jnp.where(finished[:, None], s["rad"], 0.0)
        take = finished & (s["nxt"] < s["send"])
        new_work = jnp.where(take, s["nxt"], -1)
        pixel_n, lkeys_n, o_n, d_n = spawn(new_work)
        pixel = jnp.where(take, pixel_n, s["pixel"])
        lkeys = jnp.where(take[:, None], lkeys_n, s["lkeys"])
        o = vm.where(take, o_n, s["o"])
        d = vm.where(take, d_n, s["d"])
        thr = vm.where(take, jnp.ones_like(s["thr"]), s["thr"])
        rad = vm.where(take, jnp.zeros_like(s["rad"]), s["rad"])
        depth = jnp.where(take, 0, s["depth"])
        work = jnp.where(take, new_work, jnp.where(finished, -1, work))
        return dict(
            s, work=work, pixel=pixel, lkeys=lkeys, o=o, d=d, thr=thr,
            rad=rad, depth=depth, alive=alive | take,
            nxt=s["nxt"] + take.astype(jnp.int32), acc_lane=acc_lane,
            hist=hist,
        )

    def cond(s):
        # pending = finished-but-unflushed; loop runs until every path
        # has been traced AND flushed
        return jnp.any(s["alive"]) | jnp.any(~s["alive"] & (s["work"] >= 0))

    def window(s):
        for _ in range(flush_every):
            s = bounce(s)
        return advance_stripe(s) if use_stripe else flush_refill(s)

    state = jax.lax.while_loop(cond, window, state)

    if use_stripe:
        acc = jnp.zeros((npix, 3), jnp.float32).at[state["pixel"]].add(
            state["acc_lane"]
        )
    else:
        acc = state["acc"]
    img = (acc / jnp.float32(spp)).reshape(height, width, 3)
    # path-length counts -> the chunked renderer's per-bounce occupancy:
    # a path of length L traced a segment at bounces 0..L-1, so
    # occupancy[b] = #paths with length > b (suffix sum of hist)
    suffix = jnp.cumsum(state["hist"][::-1])[::-1]
    occupancy = jnp.concatenate(
        [suffix[1:], jnp.zeros((1,), jnp.float32)]
    )
    stats = TraceStats(
        segments=state["segments"],
        bounces=state["iters"],
        occupancy=occupancy,
    )
    return img, stats

"""Iterative wavefront path-tracing integrator.

The reference integrator is the recursive ``Ray::color`` (ray.rs:20-41):

    color(ray, B):
      B == 0                -> black
      miss                  -> background
      hit                   -> emitted + (scatter ? attenuation * color(scattered, B-1)
                                                  : 0)

Recursion does not map onto a vectorized accelerator; the wavefront
rewrite carries (origin, direction, throughput, radiance, alive) for every lane
and peels one bounce per loop iteration:

    radiance += throughput * emitted            (hit lanes)
    radiance += throughput * background         (miss lanes; lane dies)
    throughput *= attenuation                   (scatter lanes)
    lane dies when absorbed (metal grazing / light) or at max_bounces

which computes exactly the same sum — the product of attenuations along
the path times the emitted/background term where it terminates.

Two loop modes:

* ``lax.while_loop`` (default) — exits early once every lane is dead
  (the reference's per-ray adaptive depth, per-batch here);
* ``lax.scan`` (``differentiable=True``) — fixed max_bounces trip
  count, reverse-mode differentiable.

Differentiation uses **detached sampling**: the discrete hit *search*
(BVH walk / argmin, both integer-valued and containing a while_loop)
runs on stop-gradient inputs, then the chosen primitive's hit distance
is RE-evaluated differentiably, so radiance gradients flow through hit
geometry, shading, textures and the camera — while visibility
discontinuities are (bias-accepted) ignored, per the standard
reparameterized-path-tracing recipe.

Optional per-bounce Russian roulette (OFF by default — the reference
has none; it changes variance, not the mean) boosts deep-bounce scenes.

t_min = 0.001 shadow-acne epsilon (ray.rs:25), in units of |direction|
because directions are unnormalized, exactly like the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from rust_pathtracer_tpu import sampling
from rust_pathtracer_tpu import vecmath as vm
from rust_pathtracer_tpu.materials import emitted, scatter, shade_inputs
from rust_pathtracer_tpu.ops.intersect import closest_hit, hit_record, prim_intersect_t

T_MIN = 1e-3  # ray.rs:25
T_MAX = np.float32(1.0e30)


class TraceStats(NamedTuple):
    segments: jnp.ndarray   # f32 scalar: total ray segments traced
    bounces: jnp.ndarray    # i32 scalar: bounce iterations executed
    occupancy: jnp.ndarray  # f32 (MAX_BOUNCE_STATS,): alive lanes per bounce


# fixed histogram length so TraceStats shapes are static across scenes
MAX_BOUNCE_STATS = 64


def _find_hit(scene, o, d, differentiable):
    """Closest-hit; in differentiable mode the discrete search is
    detached and the winning primitive's t is re-derived (via a one-hot
    row contraction) so gradients flow through hit geometry."""
    sg = jax.lax.stop_gradient
    hit_mask, t_search, idx = closest_hit(
        sg(scene), sg(o), sg(d), T_MIN, T_MAX
    )
    if not differentiable:
        return hit_mask, jnp.where(hit_mask, t_search, 1.0), idx, None

    # name the discrete search results so the remat policy saves them:
    # the backward sweep then re-runs only the differentiable shading,
    # not the (stop-gradient) BVH walk / Pallas sweep
    from jax.ad_checkpoint import checkpoint_name

    hit_mask = checkpoint_name(hit_mask, "hit_mask")
    idx = checkpoint_name(idx, "hit_idx")

    from rust_pathtracer_tpu.ops.intersect import gather_prim_rows

    # ONE one-hot row gather, shared with the hit record (the round-2
    # code gathered twice: once here for t, once inside hit_record —
    # two 1M x P HIGHEST-precision contractions per bounce)
    rows = gather_prim_rows(scene.prims, idx)
    kind, aux, data, _mat = rows

    import os

    if os.environ.get("RPT_DIFF_T", "analytic") == "analytic":
        # implicit-function linearization (DEFAULT): bitwise the
        # detached t in the forward — so the diff forward follows the
        # search's t exactly, like the nondiff path, instead of a
        # re-derived t that can differ in ulps — with exact first-order
        # grads w.r.t. (o, d); skips the full differentiable
        # re-intersection.  RPT_DIFF_T=rederive restores the
        # re-derivation.
        t = _analytic_t(
            kind, aux, data, o, d,
            jnp.where(hit_mask, t_search, 1.0), scene.prim_types,
        )
        return hit_mask, t, idx, rows

    t_diff, _ = prim_intersect_t(
        kind, aux, data, o, d, T_MIN, T_MAX, prim_types=scene.prim_types
    )
    # dead/miss lanes get a harmless finite t so downstream math stays
    # NaN-free (NaNs in unselected `where` branches poison gradients)
    t = jnp.where(hit_mask, t_diff, 1.0)
    return hit_mask, t, idx, rows


def _analytic_t(kind, aux, data, o, d, t_det, prim_types):
    """Differentiable hit distance via the implicit function theorem.

    For a hit on surface F(x) = 0 at x = o + t d, the exact derivative
    is dt = -(n.do + t n.dd) / (n.d) with n = grad F at the hit, so

        t(o, d) = sg(t) - (n.(o - sg o) + sg(t) n.(d - sg d)) / sg(n.d)

    is bitwise sg(t) in the forward pass and carries the exact
    first-order (o, d) sensitivities — no re-intersection, no sqrt /
    Moller-Trumbore replay.  n per kind: sphere grad |x-c|^2 ~ (x-c);
    rect: the fixed-axis unit vector; triangle: e1 x e2.  Scene
    geometry itself is not a differentiable leaf (grad.py DiffParams),
    so n under stop_gradient loses nothing.

    GEOMETRY-GRADIENT LIMITATION: because n, t_det and the primitive
    rows are all stop-gradiented here, d(t)/d(scene.prims.data) is
    ZERO under this default — a caller differentiating directly w.r.t.
    raw primitive arrays (not a DiffParams leaf) silently loses the
    hit-distance term.  Set RPT_DIFF_T=rederive to restore the round-2
    differentiable re-intersection, which carries it.
    """
    from rust_pathtracer_tpu.ops.intersect import (
        PRIM_RECT,
        PRIM_SPHERE,
        PRIM_TRIANGLE,
        _axis_onehot,
    )

    sg = jax.lax.stop_gradient
    types = prim_types if prim_types is not None else (0, 1, 2)
    point = sg(o) + t_det[..., None] * sg(d)
    n = jnp.zeros_like(o)
    if PRIM_SPHERE in types:
        n = vm.where(kind == PRIM_SPHERE, point - data[..., 0:3], n)
    if PRIM_RECT in types:
        n = vm.where(kind == PRIM_RECT, _axis_onehot(aux), n)
    if PRIM_TRIANGLE in types:
        n = vm.where(
            kind == PRIM_TRIANGLE,
            vm.cross(data[..., 3:6], data[..., 6:9]), n,
        )
    n = sg(n)
    den = vm.dot(n, sg(d))
    den = jnp.where(jnp.abs(den) < 1e-30, 1.0, den)
    return t_det - (
        vm.dot(n, o - sg(o)) + t_det * vm.dot(n, d - sg(d))
    ) / den


def search_and_record(scene, o, d, alive, differentiable=False):
    """Closest-hit search + HitRecord on the composed jnp path.

    Returns (hit_mask & alive, record with valid = that mask).  In diff
    mode the record reuses the primitive rows _find_hit gathered.
    """
    hit_mask, t, idx, rows = _find_hit(scene, o, d, differentiable)
    hit_mask = hit_mask & alive
    if rows is not None:
        from rust_pathtracer_tpu.ops.intersect import record_from_rows

        kind, aux, data, mat = rows
        rec = record_from_rows(
            kind, aux, data, mat,
            jnp.clip(idx, 0, scene.prims.kind.shape[0] - 1),
            o, d, t, hit_mask, scene.prim_types,
        )
    else:
        rec = hit_record(
            scene.prims, idx, o, d, t, hit_mask,
            prim_types=scene.prim_types,
        )
    return hit_mask, rec


def sort_carry(keys, arrays):
    """Sort ``arrays`` by ``keys`` (+ an iota tie-break key) in ONE
    lax.sort, carrying every payload word through the sort network.

    The permutation rides the sort network instead of one x[perm] row
    gather per array.  The iota key makes the order unique, so the
    result is bitwise identical to a stable perm-then-gather.

    ``arrays``: list of (R,) or (R, k) arrays (k-column arrays are
    carried as k separate words).  Returns the sorted arrays in the
    same shapes/order.
    """
    R = arrays[0].shape[0]
    iota = jnp.arange(R, dtype=jnp.int32)
    cols, spec = [], []
    for a in arrays:
        if a.ndim == 1:
            cols.append(a)
            spec.append(None)
        else:
            k = a.shape[1]
            cols.extend(a[:, j] for j in range(k))
            spec.append(k)
    out = jax.lax.sort(tuple(keys) + (iota,) + tuple(cols),
                       num_keys=len(keys) + 1)
    flat = list(out[len(keys) + 1:])
    res, i = [], 0
    for s in spec:
        if s is None:
            res.append(flat[i])
            i += 1
        else:
            res.append(jnp.stack(flat[i:i + s], axis=1))
            i += s
    return res


def _precompute_draws(lane_keys, max_bounces, rr_start, start_bounce=0):
    """Per-bounce RNG draws for bounces [start_bounce, max_bounces).

    The draws depend only on (lane_key, bounce, purpose) — never on the
    path state — so a fixed-length scan can consume them as ``xs`` (and
    a while_loop as a dynamic slice) instead of re-deriving threefry
    chains inside every bounce body.

    Only the UNIFORMS are hoisted (threefry chains + bit manipulation
    — exact integer/float ops, bitwise identical at any batch shape);
    the trig transforms (on_unit_sphere / in_unit_sphere) stay in the
    loop body at the wavefront's own shape.  Hoisting the transformed
    draws broke the cascade == plain estimator-identity invariant:
    XLA vectorizes the transcendental path differently per batch
    shape (ulp-level), and the cascade precomputes per stage at the
    compacted width while the plain path precomputes once at full
    width (caught by test_render_scenes.test_cascade_*).  Returns a
    dict of (B, R, ...) uniform arrays indexed by
    (bounce - start_bounce); roulette only when it can fire.
    """
    sg = jax.lax.stop_gradient
    rr = rr_start < max_bounces

    import os

    if os.environ.get("RPT_RNG_SCHEME", "legacy") == "packed":
        # counter-mode packed draws: 4 threefry blocks per lane-bounce
        # instead of ~5.3 block-equivalents of per-purpose fold chains
        b = jnp.arange(start_bounce, max_bounces, dtype=jnp.uint32)
        su, bu, cn, rl = sampling.scatter_uniforms(
            lane_keys, b[:, None], rr
        )
        out = dict(sphere_u=sg(su), ball_u=sg(bu), coin=sg(cn))
        if rr:
            out["roulette"] = sg(rl)
        # pin the hoist: without the barrier XLA rematerializes the
        # (cheap-looking) counter-mode threefry INTO the while_loop
        # body, recomputing draws per bounce
        if os.environ.get("RPT_RNG_BARRIER", "1") == "1":
            out = jax.lax.optimization_barrier(out)
        return out

    def draws_for(b):
        out = dict(
            sphere_u=sg(sampling.uniform2(
                sampling.bounce_keys(lane_keys, b, sampling.P_LAMBERT))),
            ball_u=sg(sampling.uniform3(
                sampling.bounce_keys(lane_keys, b, sampling.P_FUZZ))),
            coin=sg(sampling.uniform(
                sampling.bounce_keys(lane_keys, b, sampling.P_SCHLICK))),
        )
        if rr:
            out["roulette"] = sg(sampling.uniform(
                sampling.bounce_keys(lane_keys, b, sampling.P_ROULETTE)))
        return out

    return jax.vmap(draws_for)(
        jnp.arange(start_bounce, max_bounces, dtype=jnp.int32)
    )


def _bounce_step(scene, lane_keys, background, rr_start, state, bounce,
                 differentiable=False, draws=None):
    o, d, thr, rad = state["o"], state["d"], state["thr"], state["rad"]
    alive = state["alive"]
    n_alive = jnp.sum(alive.astype(jnp.float32))
    segments = state["segments"] + n_alive
    occupancy = jax.lax.dynamic_update_slice(
        state["occupancy"], n_alive[None],
        (jnp.minimum(bounce, MAX_BOUNCE_STATS - 1),),
    )

    # fused whole bounce (ops/fused_bounce.py): search + record +
    # texture + scatter + commit in ONE function for small static scenes
    # with table-free shading.  RNG draws stay outside it (bitwise
    # jax.random), as do roulette and the stats above.
    from rust_pathtracer_tpu.ops.fused_bounce import (
        fused_bounce_apply,
        fused_bounce_diff_apply,
        fused_bounce_diff_ok,
        fused_bounce_ok,
    )

    use_fb = not differentiable and fused_bounce_ok(scene)
    use_fbd = differentiable and fused_bounce_diff_ok(scene)
    if use_fb or use_fbd:
        sg = jax.lax.stop_gradient
        if draws is not None:
            # hoisted uniforms go straight into the fused body — the
            # on/in-unit-sphere transforms run inside it (bitwise
            # stable at every width by construction)
            sphere_u, ball_u, coin = (
                draws["sphere_u"], draws["ball_u"], draws["coin"]
            )
        else:
            su_, bu_, cn_, _ = sampling.bounce_draws(lane_keys, bounce,
                                                     False)
            sphere_u, ball_u, coin = sg(su_), sg(bu_), sg(cn_)
        apply_fn = fused_bounce_diff_apply if use_fbd else fused_bounce_apply
        o, d, thr, rad, alive = apply_fn(
            scene, o, d, thr, rad, alive, sphere_u, ball_u, coin,
            background, T_MIN,
        )

        def roulette_fb(args):
            thr, alive = args
            p = jnp.clip(
                jnp.max(jax.lax.stop_gradient(thr), axis=-1), 0.05, 1.0
            )
            has_rr = draws is not None and "roulette" in draws
            u = (draws["roulette"] if has_rr
                 else sampling.bounce_draws(lane_keys, bounce, True)[3])
            survive = u < p
            thr = jnp.where((alive & survive)[..., None],
                            thr / p[..., None], thr)
            return thr, alive & survive

        thr, alive = jax.lax.cond(
            bounce >= rr_start, roulette_fb, lambda args: args, (thr, alive)
        )
        return dict(
            state,
            o=o, d=d, thr=thr, rad=rad, alive=alive,
            segments=segments, occupancy=occupancy,
        )

    hit_mask, rec = search_and_record(scene, o, d, alive, differentiable)
    if differentiable:
        # tag the hit record for the "mid" remat policy (see trace):
        # saving these lets the backward replay skip the whole
        # re-derived t chain (gather_prim_rows + prim_intersect_t)
        from jax.ad_checkpoint import checkpoint_name as _cn

        rec = rec._replace(
            point=_cn(rec.point, "rec_point"),
            normal=_cn(rec.normal, "rec_normal"),
            front_face=_cn(rec.front_face, "rec_front"),
            u=_cn(rec.u, "rec_u"),
            v=_cn(rec.v, "rec_v"),
        )
    si = shade_inputs(scene, rec)
    if differentiable:
        si = si._replace(
            kind=_cn(si.kind, "shade_kind"),
            fuzz=_cn(si.fuzz, "shade_fuzz"),
            ir=_cn(si.ir, "shade_ir"),
            value=_cn(si.value, "shade_value"),
        )

    # miss -> background, weighted by throughput (ray.rs:40)
    miss = alive & ~hit_mask
    rad = rad + jnp.where(miss[..., None], thr * background, 0.0)

    # hit -> emitted (ray.rs:26), then scatter (ray.rs:28-34)
    em = emitted(scene, rec, si)
    rad = rad + jnp.where(hit_mask[..., None], thr * em, 0.0)

    sg = jax.lax.stop_gradient  # detached sampling: draws carry no grads
    if draws is not None:
        # hoisted uniforms, in-body transforms: bitwise the values
        # below (see _precompute_draws for why the split matters)
        sphere_dir = sampling.on_unit_sphere_from_u(draws["sphere_u"])
        ball_dir = sampling.in_unit_sphere_from_u(draws["ball_u"])
        coin = draws["coin"]
    else:
        su_, bu_, cn_, _ = sampling.bounce_draws(lane_keys, bounce, False)
        sphere_dir = sg(sampling.on_unit_sphere_from_u(su_))
        ball_dir = sg(sampling.in_unit_sphere_from_u(bu_))
        coin = sg(cn_)
    if differentiable:
        sphere_dir = _cn(sphere_dir, "rng_sphere")
        ball_dir = _cn(ball_dir, "rng_ball")
        coin = _cn(coin, "rng_coin")
    sc = scatter(scene, rec, d, sphere_dir, ball_dir, coin, si)
    if differentiable:
        sc = sc._replace(
            did_scatter=_cn(sc.did_scatter, "scatter_did"),
            direction=_cn(sc.direction, "scatter_dir"),
            attenuation=_cn(sc.attenuation, "scatter_att"),
        )

    cont = hit_mask & sc.did_scatter
    thr = jnp.where(cont[..., None], thr * sc.attenuation, thr)
    o = vm.where(cont, rec.point, o)
    d = vm.where(cont, sc.direction, d)
    alive = cont

    # optional russian roulette (no reference counterpart)
    def roulette(args):
        thr, alive = args
        p = jnp.clip(jnp.max(jax.lax.stop_gradient(thr), axis=-1), 0.05, 1.0)
        has_rr = draws is not None and "roulette" in draws
        u = (draws["roulette"] if has_rr
             else sampling.bounce_draws(lane_keys, bounce, True)[3])
        survive = u < p
        thr = jnp.where((alive & survive)[..., None], thr / p[..., None], thr)
        return thr, alive & survive

    thr, alive = jax.lax.cond(
        bounce >= rr_start, roulette, lambda args: args, (thr, alive)
    )
    return dict(
        state,
        o=o, d=d, thr=thr, rad=rad, alive=alive,
        segments=segments, occupancy=occupancy,
    )


def _resolve_remat_mode(remat, lanes, max_bounces):
    """Resolve the effective remat policy for a diff trace.

    Single source of truth for the RPT_REMAT env fallback and the
    "auto" threshold (~24M lane-bounces ≈ 7 GB of residuals; set on a
    16 GB TPU, where saving everything beat the names policy while
    residuals fit — not yet measured on the GPU) — used by both the fused-cols eligibility check and trace()'s
    generic diff route so the two can never disagree about which mode
    a config resolves to (round-4 ADVICE item).
    """
    import os

    mode = remat or os.environ.get("RPT_REMAT", "auto")
    if mode == "auto":
        mode = "none" if lanes * max_bounces <= 24_000_000 else "mid"
    return mode


def _diff_cascade_stages(max_bounces, n_lanes):
    """Parse RPT_DIFF_CASCADE="8:2,14:4" into [(boundary, shrink), ...].

    The static-width differentiable cascade: at each ``boundary`` the
    scan narrows to ``n_lanes/shrink`` lanes (live lanes sorted to the
    front).  Widths are STATIC — chosen from the scene's occupancy
    curve with margin (CornellBox 512^2: 31% alive at bounce 8, 16% at
    14 -> "8:2,14:4" has ~1.6x headroom) — so reverse-mode AD sees a
    fixed-shape graph: no lax.cond, no host sync.  If a live lane ever
    falls past the slice (occupancy above the static budget) it is
    DROPPED and the image/gradients are biased; the count of
    dropped-live lanes is recorded in occupancy slot
    MAX_BOUNCE_STATS-1 and MUST be asserted zero by whoever enables
    this env var (tests/test_grad.py does; nothing enables it in
    production — it exists as a documented negative result,
    DESIGN.md §10).
    """
    import os

    raw = os.environ.get("RPT_DIFF_CASCADE")
    if not raw:
        return []
    if max_bounces >= MAX_BOUNCE_STATS - 1:
        return []  # overflow slot would alias a real bounce count
    from rust_pathtracer_tpu.render import parse_cascade_schedule

    try:
        pairs = parse_cascade_schedule(raw)
    except ValueError:
        return []  # malformed: fall back to the plain scan
    for b, s in pairs:
        if not (b < max_bounces and n_lanes % s == 0):
            return []  # inapplicable to this lane count
    return pairs


def _trace_diff_cascade(init, lane_keys, make_step, stages, max_bounces):
    """Fixed-length scans between static compaction boundaries.

    Per-lane radiance is estimator-identical to the plain scan (each
    lane carries its RNG key and global bounce index); only the f32
    order in which a lane's per-stage partial sums combine differs.
    Returns {rad (full width, caller order), segments, occupancy}
    with the dropped-live-lane count in occupancy[-1] (see
    _diff_cascade_stages).
    """
    R = init["o"].shape[0]
    # derive from the carried arrays so shard_map's varying-axis
    # tracking gives banked/lane the same mesh axes as the wavefront
    # (see trace() / trace_cascaded_static)
    zeros3_full = init["o"] * 0.0
    banked = zeros3_full
    lane = (zeros3_full[..., 0] == 1.0).astype(jnp.int32) + np.arange(
        R, dtype=np.int32
    )
    state = dict(init)
    lk = lane_keys
    segments = jnp.float32(0.0)
    occupancy = jnp.zeros((MAX_BOUNCE_STATS,), jnp.float32)
    overflow = jnp.float32(0.0)
    b0 = 0
    for b1, shrink in list(stages) + [(max_bounces, None)]:
        step = make_step(lk)
        state, _ = jax.lax.scan(
            lambda s, b: (step(s, b, None), None),
            state, jnp.arange(b0, b1, dtype=jnp.int32),
        )
        segments = segments + state["segments"]
        occupancy = occupancy + state["occupancy"]
        banked = banked.at[lane].add(state["rad"])
        if shrink is None:
            break
        alive = state["alive"]
        S = R // shrink
        iota = jnp.arange(alive.shape[0], dtype=jnp.int32)
        perm = jax.lax.stop_gradient(
            jax.lax.sort(((~alive).astype(jnp.int32), iota), num_keys=1,
                         is_stable=True)[1]
        )
        overflow = overflow + jnp.sum(
            alive[perm][S:].astype(jnp.float32)
        )
        zeros3 = state["o"][perm][:S] * 0.0
        zero_scalar = jnp.sum(zeros3[..., 0])
        state = dict(
            o=state["o"][perm][:S],
            d=state["d"][perm][:S],
            thr=state["thr"][perm][:S],
            rad=zeros3,
            alive=alive[perm][:S],
            segments=zero_scalar,
            occupancy=zero_scalar + jnp.zeros(
                (MAX_BOUNCE_STATS,), jnp.float32
            ),
        )
        lane = lane[perm][:S]
        lk = lk[perm][:S]
        b0 = b1
    occupancy = occupancy.at[MAX_BOUNCE_STATS - 1].add(overflow)
    return dict(rad=banked, segments=segments, occupancy=occupancy)


def _fused_cols_eligible(scene, differentiable, remat, max_bounces,
                         lanes):
    """Route to the column-native fused scan (_trace_fused_cols)?

    For fused-bounce-eligible scenes on the plain (non-cascade,
    remat="none") paths — everything else keeps the generic state-dict
    loops."""
    from rust_pathtracer_tpu.ops.fused_bounce import (
        fused_bounce_diff_ok,
        fused_bounce_ok,
    )

    if not differentiable:
        return fused_bounce_ok(scene)
    if not fused_bounce_diff_ok(scene):
        return False
    mode = _resolve_remat_mode(remat, lanes, max_bounces)
    return mode == "none" and not _diff_cascade_stages(max_bounces, lanes)


def _trace_fused_cols(scene, origins, directions, lane_keys, background,
                      max_bounces, rr_start, differentiable):
    """Column-native trace for fused-bounce scenes.

    The scan/while_loop carry holds the wavefront as 13 SEPARATE (R,)
    columns instead of (R, 3) AoS arrays: every reshape to the
    fused body's columns are then contiguous (free), where the
    AoS carry paid ~26 strided column-extract/stack copies per bounce
    in the forward AND the transposed sweep.  Estimator-identical to
    the _bounce_step fused branch op-for-op (same body, same draw
    uniforms, same roulette formulas), so cascade == plain invariants
    hold bitwise across the two drivers."""
    import os

    from rust_pathtracer_tpu.ops.fused_bounce import (
        _COL_KEYS,
        fused_bounce_cols_step,
    )

    sg = jax.lax.stop_gradient
    zeros = origins[:, 0] * 0.0
    ones = zeros + 1.0
    zero_scalar = jnp.sum(zeros)
    cols = dict(zip(_COL_KEYS, (
        origins[:, 0], origins[:, 1], origins[:, 2],
        directions[:, 0], directions[:, 1], directions[:, 2],
        ones, ones, ones, zeros, zeros, zeros, ones,
    )))
    occupancy0 = zero_scalar + jnp.zeros((MAX_BOUNCE_STATS,), jnp.float32)

    # uniforms hoist: default ON, bit-exact at any width (integer
    # draws only; transforms run in the fused body); the whole-scan VJP below
    # requires it
    draws_all = None
    if os.environ.get("RPT_RNG_XS", "1") == "1" and max_bounces > 1:
        draws_all = _precompute_draws(lane_keys, max_bounces, rr_start)

    def draw_cols(bounce, d_b):
        if d_b is not None:
            su, bu, cn = d_b["sphere_u"], d_b["ball_u"], d_b["coin"]
        else:
            su_, bu_, cn_, _ = sampling.bounce_draws(lane_keys, bounce,
                                                     False)
            su, bu, cn = sg(su_), sg(bu_), sg(cn_)
        return su[:, 0], su[:, 1], bu[:, 0], bu[:, 1], bu[:, 2], cn

    def bounce_body(carry, bounce, d_b):
        cols, segments, occupancy = (
            carry["cols"], carry["segments"], carry["occupancy"]
        )
        n_alive = jnp.sum(cols["al"])
        segments = segments + n_alive
        occupancy = jax.lax.dynamic_update_slice(
            occupancy, n_alive[None],
            (jnp.minimum(bounce, MAX_BOUNCE_STATS - 1),),
        )
        su0, su1, bu0, bu1, bu2, cn = draw_cols(bounce, d_b)
        cols = fused_bounce_cols_step(
            scene, cols, su0, su1, bu0, bu1, bu2, cn, background,
            T_MIN, differentiable,
        )

        def roulette(args):
            t0, t1, t2, al = args
            # op-for-op the _bounce_step fused-branch roulette (same
            # max tree, same division) — max is associative, so the
            # column form is bitwise the (R, 3) axis reduce
            p = jnp.clip(
                jnp.maximum(jnp.maximum(sg(t0), sg(t1)), sg(t2)),
                0.05, 1.0,
            )
            has_rr = d_b is not None and "roulette" in d_b
            u = (d_b["roulette"] if has_rr
                 else sampling.bounce_draws(lane_keys, bounce, True)[3])
            act = (al > 0.5) & (u < p)
            t0 = jnp.where(act, t0 / p, t0)
            t1 = jnp.where(act, t1 / p, t1)
            t2 = jnp.where(act, t2 / p, t2)
            al = jnp.where(al > 0.5, act.astype(jnp.float32), al)
            return t0, t1, t2, al

        if rr_start < max_bounces:  # static: RR can ever fire at all
            t0, t1, t2, al = jax.lax.cond(
                bounce >= rr_start, roulette, lambda a: a,
                (cols["t0"], cols["t1"], cols["t2"], cols["al"]),
            )
            cols = dict(cols, t0=t0, t1=t1, t2=t2, al=al)
        return dict(cols=cols, segments=segments, occupancy=occupancy)

    # whole-scan custom VJP (ops/fused_bounce.fused_scan_trace): ONE
    # custom_vjp around the entire bounce loop with a hand-written
    # reversed backward scan — removes jax's scan-transpose machinery.
    # Primal bitwise-identical to the scan below; requires the hoisted
    # draws (xs).  RPT_FBD_SCAN=jax restores the lax.scan transpose.
    if (differentiable and draws_all is not None
            and os.environ.get("RPT_FBD_SCAN", "vjp") == "vjp"):
        from rust_pathtracer_tpu.ops.fused_bounce import fused_scan_trace

        unroll = int(os.environ.get("RPT_SCAN_UNROLL", "4"))
        c, segments, occupancy = fused_scan_trace(
            scene, cols, draws_all, background, T_MIN, max_bounces,
            rr_start, MAX_BOUNCE_STATS, unroll=unroll,
        )
        rad = jnp.stack([c["r0"], c["r1"], c["r2"]], axis=1)
        return rad, TraceStats(
            segments=segments, bounces=jnp.int32(max_bounces),
            occupancy=occupancy,
        )

    carry0 = dict(cols=cols, segments=zero_scalar, occupancy=occupancy0)
    if differentiable:
        unroll = int(os.environ.get("RPT_SCAN_UNROLL", "4"))
        split_t = os.environ.get("RPT_SCAN_SPLIT_T", "0") == "1"
        bidx = jnp.arange(max_bounces, dtype=jnp.int32)
        if draws_all is not None:
            carry, _ = jax.lax.scan(
                lambda c, x: (bounce_body(c, x[0], x[1]), None),
                carry0, (bidx, draws_all),
                unroll=unroll, _split_transpose=split_t,
            )
        else:
            carry, _ = jax.lax.scan(
                lambda c, b: (bounce_body(c, b, None), None),
                carry0, bidx,
                unroll=unroll, _split_transpose=split_t,
            )
        bounces_done = jnp.int32(max_bounces)
    else:
        def cond(c):
            bounce, carry = c
            return (bounce < max_bounces) & jnp.any(carry["cols"]["al"] > 0.5)

        def body(c):
            bounce, carry = c
            d_b = None if draws_all is None else jax.tree_util.tree_map(
                lambda a: jax.lax.dynamic_index_in_dim(
                    a, bounce, 0, keepdims=False), draws_all,
            )
            return bounce + 1, bounce_body(carry, bounce, d_b)

        bounces_done, carry = jax.lax.while_loop(
            cond, body, (jnp.int32(0), carry0)
        )

    c = carry["cols"]
    rad = jnp.stack([c["r0"], c["r1"], c["r2"]], axis=1)
    return rad, TraceStats(
        segments=carry["segments"], bounces=bounces_done,
        occupancy=carry["occupancy"],
    )


def trace(
    scene,
    origins,
    directions,
    lane_keys,
    background,
    max_bounces: int,
    russian_roulette_start: Optional[int] = None,
    differentiable: bool = False,
    remat: Optional[str] = None,
):
    """Estimate radiance for a wavefront of rays.

    origins, directions: (R, 3); lane_keys: (R, 2) counter-based keys;
    background: (3,) miss color (scene.rs ImageSettings.background).
    Returns (radiance (R, 3), TraceStats).

    Differentiable w.r.t. the official DiffParams leaves (textures,
    camera-derived origins/directions, background) — exact to first
    order.  NOTE: under the default RPT_DIFF_T=analytic, gradients
    taken directly w.r.t. raw primitive arrays (scene.prims.data) omit
    the hit-distance term d(t)/d(geometry) (see _analytic_t); use
    RPT_DIFF_T=rederive for full geometry gradients.
    """
    background = jnp.asarray(background, jnp.float32)
    rr_start = (
        max_bounces + 1 if russian_roulette_start is None else russian_roulette_start
    )

    # derive the carry init arithmetically from the (possibly
    # mesh-varying) ray arrays so shard_map's varying-axis tracking
    # sees matching carry types on both sides of the loop
    zeros3 = origins * 0.0
    zero_scalar = jnp.sum(zeros3[..., 0])
    init = dict(
        o=origins,
        d=directions,
        thr=zeros3 + 1.0,
        rad=zeros3,
        alive=zeros3[..., 0] == 0.0,        # alive (origins are finite)
        segments=zero_scalar,
        occupancy=zero_scalar + jnp.zeros((MAX_BOUNCE_STATS,), jnp.float32),
    )
    if _fused_cols_eligible(scene, differentiable, remat, max_bounces,
                            origins.shape[0]):
        return _trace_fused_cols(
            scene, origins, directions, lane_keys, background,
            max_bounces, rr_start, differentiable,
        )

    if differentiable:
        # remat each bounce: the backward sweep recomputes the bounce
        # forward instead of saving every intermediate of every bounce
        # (HBM-bound otherwise: ~20 bounces x O(100B)/lane of residuals).
        # Exception: the discrete hit-search results (5 B/lane/bounce)
        # are saved so the expensive search itself is not re-run.
        import os

        # Remat policy: when the per-bounce residuals fit in device
        # memory, saving everything beats recomputing shading (set on
        # a 16 GB TPU; not yet measured on the GPU).  "auto" (the
        # default) disables remat up to ~24M lane-bounces (~7 GB of
        # residuals) and falls back to the "mid" policy beyond;
        # RPT_REMAT overrides ("names" / "none").
        # NOTE: the env fallback is read at TRACE time — invisible to a
        # same-shape second call (jit cache).  Callers that vary the
        # policy must pass ``remat`` (a static jit arg upstream) or
        # clear caches; see RenderSettings.remat.
        mode = _resolve_remat_mode(remat, origins.shape[0], max_bounces)
        def make_step(lk):
            if mode == "bf16":
                # save-everything backward with residuals stored in
                # bfloat16 (ops/compressed_vjp.py): halves the
                # residual write + transposed-read traffic under a
                # DOCUMENTED accuracy contract — gradients within
                # ~1e-2 normalized error of the f32-residual grads
                # (tests/test_grad.py pins it); the primal forward is
                # bitwise unchanged.
                from rust_pathtracer_tpu.ops.compressed_vjp import (
                    compressed_fn,
                )

                base = compressed_fn(
                    lambda state, scene_, background_, lk_, bounce:
                        _bounce_step(scene_, lk_, background_, rr_start,
                                     state, bounce, differentiable=True)
                )
                return lambda state, bounce, draws: base(
                    state, scene, background, lk, bounce
                )
            if mode == "none":
                return lambda state, bounce, draws: _bounce_step(
                    scene, lk, background, rr_start, state, bounce,
                    differentiable=True, draws=draws,
                )
            # "mid": save the bounce's *interface* values (hit record,
            # shade inputs, RNG draws, scatter outputs) so the backward
            # replay recomputes only cheap fusable elementwise updates —
            # not the detached search, not the t chain, not the RNG
            # bit-mixing.  "names": save only the discrete search ids
            # (minimum storage, replay re-runs all shading).
            names = ("hit_mask", "hit_idx")
            if mode == "mid":
                names = names + (
                    "rec_point", "rec_normal", "rec_front", "rec_u",
                    "rec_v", "shade_kind", "shade_fuzz", "shade_ir",
                    "shade_value", "rng_sphere", "rng_ball", "rng_coin",
                    "scatter_did", "scatter_dir", "scatter_att",
                )
            return jax.checkpoint(
                lambda state, bounce, draws: _bounce_step(
                    scene, lk, background, rr_start, state, bounce,
                    differentiable=True, draws=draws,
                ),
                policy=jax.checkpoint_policies.save_only_these_names(*names),
            )

        # NOTE: wrapping the scan body in lax.cond(any(alive)) to skip
        # all-dead tail bounces is bitwise-identical, but the
        # conditional is a fusion barrier in both the forward and the
        # transposed scan (DESIGN.md §10).  Keep plain fixed-length
        # bodies; the static-width diff cascade below recovers the
        # occupancy win without any conditional.
        stages = _diff_cascade_stages(max_bounces, origins.shape[0])
        if stages:
            state = _trace_diff_cascade(
                init, lane_keys, make_step, stages, max_bounces
            )
        else:
            step = make_step(lane_keys)
            # Unroll the diff scan (default 4) so XLA fuses across
            # bounce boundaries (residual writes + next bounce's
            # reads).  RPT_SCAN_UNROLL overrides (trace-time env).
            unroll = int(os.environ.get("RPT_SCAN_UNROLL", "4"))
            # RPT_SCAN_SPLIT_T=1: lax.scan's experimental transpose
            # split (backward as two passes) — probe knob
            split_t = os.environ.get("RPT_SCAN_SPLIT_T", "0") == "1"
            # RPT_RNG_XS=1: hoist every per-bounce RNG draw out of the
            # scan body into precomputed xs (see _precompute_draws) —
            # trades ~28 B/lane/bounce of xs traffic for the in-body
            # threefry chains.  Off by default in this generic diff
            # scan (the xs become extra scan-carried residuals); the
            # nondiff while_loop below defaults ON.
            bidx = jnp.arange(max_bounces, dtype=jnp.int32)
            if os.environ.get("RPT_RNG_XS", "0") == "1" and mode != "bf16":
                draws_all = _precompute_draws(lane_keys, max_bounces, rr_start)
                state, _ = jax.lax.scan(
                    lambda s, x: (step(s, x[0], x[1]), None),
                    init, (bidx, draws_all),
                    unroll=unroll, _split_transpose=split_t,
                )
            else:
                state, _ = jax.lax.scan(
                    lambda s, b: (step(s, b, None), None),
                    init, bidx,
                    unroll=unroll, _split_transpose=split_t,
                )
        bounces_done = jnp.int32(max_bounces)
    else:
        import os

        # Per-bounce RNG precompute (default ON here: the in-loop
        # threefry chains sit on the bounce critical path).  Draw
        # VALUES are bitwise the in-loop draws; the composed image can
        # differ at the fusion-rounding ulp level (XLA contracts the
        # batched draw transform differently), like every other
        # compilation-variant knob (DESIGN.md §10 remat note).
        draws_all = None
        if (os.environ.get("RPT_RNG_XS", "1") == "1"
                and max_bounces > 1):  # B==1: see trace_resume
            draws_all = _precompute_draws(lane_keys, max_bounces, rr_start)

        def cond(carry):
            bounce, state = carry
            return (bounce < max_bounces) & jnp.any(state["alive"])

        def body(carry):
            bounce, state = carry
            d_b = None if draws_all is None else jax.tree_util.tree_map(
                lambda a: jax.lax.dynamic_index_in_dim(
                    a, bounce, 0, keepdims=False), draws_all,
            )
            return (
                bounce + 1,
                _bounce_step(scene, lane_keys, background, rr_start, state,
                             bounce, draws=d_b),
            )

        bounces_done, state = jax.lax.while_loop(cond, body, (jnp.int32(0), init))

    return state["rad"], TraceStats(
        segments=state["segments"], bounces=bounces_done,
        occupancy=state["occupancy"],
    )


def trace_resume(scene, o, d, thr, rad, alive, lane_keys, background,
                 start_bounce, max_bounces: int,
                 russian_roulette_start: Optional[int] = None):
    """Resume the forward bounce loop from an explicit wavefront state.

    Used by the cascade renderer (render.py): the wavefront is
    compacted between bounce ranges, and this continues bounces
    [start_bounce, max_bounces) on the compacted lanes.  Per-lane
    radiance is unchanged by compaction — the RNG folds on
    (lane_key, bounce index), both carried through.

    Returns (state dict, bounces executed).
    """
    background = jnp.asarray(background, jnp.float32)
    rr_start = (
        max_bounces + 1
        if russian_roulette_start is None
        else russian_roulette_start
    )
    zero_scalar = jnp.sum(o[..., 0] * 0.0)
    state = dict(
        o=o, d=d, thr=thr, rad=rad, alive=alive,
        segments=zero_scalar,
        occupancy=zero_scalar + jnp.zeros((MAX_BOUNCE_STATS,), jnp.float32),
    )

    import os

    # same RNG hoist as trace()'s nondiff loop, sliced to this stage's
    # bounce range (the cascade re-derives per stage at the compacted
    # width, so the precompute shrinks with the wavefront)
    # B == 1 stages skip the hoist: XLA constant-folds the single-
    # bounce dynamic index into the body, fusing the uniform transform
    # differently than every B > 1 body (ulp drift in the trig) —
    # which broke cascade == plain for boundary-at-1 schedules; an
    # in-body draw for one bounce costs the same anyway.
    draws_all = None
    if (os.environ.get("RPT_RNG_XS", "1") == "1"
            and max_bounces - start_bounce > 1):
        draws_all = _precompute_draws(
            lane_keys, max_bounces, rr_start, start_bounce=start_bounce
        )

    def cond(carry):
        bounce, s = carry
        return (bounce < max_bounces) & jnp.any(s["alive"])

    def body(carry):
        bounce, s = carry
        d_b = None if draws_all is None else jax.tree_util.tree_map(
            lambda a: jax.lax.dynamic_index_in_dim(
                a, bounce - start_bounce, 0, keepdims=False), draws_all,
        )
        return (
            bounce + 1,
            _bounce_step(scene, lane_keys, background, rr_start, s, bounce,
                         draws=d_b),
        )

    bounce_end, state = jax.lax.while_loop(
        cond, body, (jnp.int32(start_bounce), state)
    )
    return state, bounce_end - jnp.int32(start_bounce)


def trace_cascaded_static(scene, origins, directions, alive, lane_keys,
                          background, max_bounces: int, stages,
                          russian_roulette_start: Optional[int] = None):
    """Nondiff trace with static-schedule wavefront compaction.

    ``stages``: static ((boundary, width), ...) — at each boundary the
    live lanes sort to the front and the trace continues on the fixed-width slice.  ``banked``
    radiance and caller-index arrays ride the permutations (dense
    slice updates + gathers; no scatter at any width), and one
    key/value sort restores caller order at the end.  Live lanes
    dropped past a slice are counted into occupancy[-1] and MUST be
    asserted zero by the caller.  All ops are shard-local, so this
    runs unchanged inside shard_map (parallel/shard.py) — per-shard
    compaction with zero cross-shard communication.

    Returns (radiance (R, 3) in caller order, TraceStats).
    """
    R = origins.shape[0]
    zeros3 = origins * 0.0
    zero_scalar = jnp.sum(zeros3[..., 0])
    # AND with an all-true array derived from the rays so shard_map's
    # varying-axis tracking gives the carry the same axes as o/d (the
    # caller's mask may vary over fewer mesh axes; see trace())
    alive = alive & (zeros3[..., 0] == 0.0)
    state = dict(
        o=origins, d=directions, thr=zeros3 + 1.0, rad=zeros3, alive=alive,
    )
    banked = zeros3
    lane = (zeros3[..., 0] == 1.0).astype(jnp.int32) + np.arange(
        R, dtype=np.int32
    )
    lk = lane_keys
    segs = zero_scalar
    occ = zero_scalar + jnp.zeros((MAX_BOUNCE_STATS,), jnp.float32)
    overflow = zero_scalar
    bounces = jnp.int32(0)
    b0 = 0

    for b1, S in list(stages) + [(max_bounces, None)]:
        st, bd = trace_resume(
            scene, state["o"], state["d"], state["thr"], state["rad"],
            state["alive"], lk, background, b0, b1,
            russian_roulette_start=russian_roulette_start,
        )
        segs = segs + st["segments"]
        occ = occ + st["occupancy"]
        bounces = bounces + bd
        W = state["o"].shape[0]
        if S is None:
            banked = banked.at[:W].add(st["rad"])
            break
        st_alive = st["alive"]
        banked = banked.at[:W].add(
            jnp.where(st_alive[:, None], 0.0, st["rad"])
        )
        iota = jnp.arange(W, dtype=jnp.int32)
        keys = (jnp.where(st_alive, 0, np.int32(2 ** 30)),)
        n_alive = jnp.sum(st_alive.astype(jnp.int32))
        overflow = overflow + jnp.maximum(n_alive - S, 0).astype(jnp.float32)
        # ONE carried sort instead of perm + per-array gathers (see
        # sort_carry).  iota as the last KEY makes the order unique —
        # identical to a stable-sort perm.
        rad_m = jnp.where(st_alive[:, None], st["rad"], 0.0)
        payload = (
            st["o"][:, 0], st["o"][:, 1], st["o"][:, 2],
            st["d"][:, 0], st["d"][:, 1], st["d"][:, 2],
            st["thr"][:, 0], st["thr"][:, 1], st["thr"][:, 2],
            rad_m[:, 0], rad_m[:, 1], rad_m[:, 2],
            st_alive, lk[:, 0], lk[:, 1],
            banked[:W, 0], banked[:W, 1], banked[:W, 2], lane[:W],
        )
        out = jax.lax.sort(keys + (iota,) + payload,
                           num_keys=len(keys) + 1)
        (o0, o1, o2, d0, d1, d2, t0, t1, t2, r0, r1, r2,
         al, k0, k1, bk0, bk1, bk2, ln) = out[len(keys) + 1:]
        state = dict(
            o=jnp.stack([o0, o1, o2], 1)[:S],
            d=jnp.stack([d0, d1, d2], 1)[:S],
            thr=jnp.stack([t0, t1, t2], 1)[:S],
            rad=jnp.stack([r0, r1, r2], 1)[:S],
            alive=al[:S],
        )
        # concatenate, NOT x.at[:W].set(...) — the self-referencing
        # update miscompiles in a fused jit
        banked = jnp.concatenate(
            [jnp.stack([bk0, bk1, bk2], 1), banked[W:]], axis=0
        )
        lane = jnp.concatenate([ln, lane[W:]], axis=0)
        lk = jnp.stack([k0, k1], 1)[:S]
        b0 = b1
    occ = occ.at[-1].add(overflow)
    _, r0, r1, r2 = jax.lax.sort(
        (lane, banked[:, 0], banked[:, 1], banked[:, 2]), num_keys=1
    )
    rad = jnp.stack([r0, r1, r2], axis=1)
    return rad, TraceStats(segments=segs, bounces=bounces, occupancy=occ)

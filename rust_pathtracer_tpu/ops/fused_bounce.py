"""Fused whole bounce: search + hit record + shade + state update.

One function computes an ENTIRE wavefront bounce for small static
scenes — the unrolled closest-hit sweep, the hit record, the texture
evaluation (solid / checker / perlin-marble), the emission +
background banking, the 4-way material scatter, and the wavefront
state commit — left to XLA, which fuses it into a few loop fusions
with no device-memory round trip between the stages.  This is the vectorized rewrite of the reference's whole per-ray
hot path: ``ray.rs:20-41`` (recursive color), ``material.rs:24-166``
(scatter/emit dispatch), ``texture.rs:9-81`` (value), fused the way
the recursion fuses on a CPU — except over a block of lanes instead of
one ray.

The bounce math lives in ONE function, ``bounce_body``, written as
plain per-lane ``jnp`` over (R,) component columns with the primitive
kinds unrolled statically, and left to XLA's fuser.  The plain bounce
and the residual-writing bounce (the forward of the differentiable
step) trace the same body, so the diff-mode image is bitwise the
nondiff render's.

Division of labor per bounce:

* XLA (outside): the RNG draws (bitwise ``jax.random`` threefry —
  sphere/ball/coin uniforms enter as inputs), russian roulette, depth /
  occupancy / segments bookkeeping, and the loop carry itself.
* fused body (here): everything between "rays in" and "scattered rays,
  throughput, radiance, alive out".

Routing: ``fused_bounce_ok(scene)`` — small static scene
(``kinds_static``) whose shading is table-free in-register math:
solid / checker-of-solids / perlin textures only (``shade_static``).
Image textures or >128 prims keep the composed path.

Numerical contract: hit masks and winning primitive indices are EXACT
vs the composed jnp path; floats agree to a few ulp (fusion/FMA
differences), so either path is bitwise-deterministic per run but they
are not bitwise-identical to each other.  The material/texture
formulas replicate materials.py / textures.py / perlin.py op-for-op
(perlin via the shared ``*_planes`` core).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from rust_pathtracer_tpu.ops.intersect import T_MISS, TRI_DET_EPS
from rust_pathtracer_tpu.perlin import marble_planes
from rust_pathtracer_tpu.scene.types import (
    MAT_DIELECTRIC,
    MAT_LAMBERTIAN,
    MAT_LIGHT,
    MAT_METAL,
    PRIM_RECT,
    PRIM_SPHERE,
    PRIM_TRIANGLE,
    TEX_CHECKER,
    TEX_PERLIN,
    TEX_SOLID,
)
from rust_pathtracer_tpu.vecmath import _SAFE_EPS, NEAR_ZERO

_RECT_FREE = {0: (1, 2), 1: (0, 2), 2: (0, 1)}

# packed primitive table rows (pack_prims_shaded):
#   0-11  Primitives.data row
#   12-14 prim kind / aux / material id
#   16-29 flattened shading row (material + texture), so the body
#         needs NO per-lane table lookups:
#   16 mat kind, 17 fuzz, 18 ir, 19 tex kind, 20 tex scale,
#   21-23 solid color, 24-26 checker odd color, 27-29 checker even color
PAY_MKIND, PAY_FUZZ, PAY_IR, PAY_TKIND, PAY_TSCALE = 16, 17, 18, 19, 20
PAY_COLOR, PAY_ODD, PAY_EVEN = 21, 24, 27
PAY_W = 32


def fused_bounce_ok(scene) -> bool:
    """Static routing: can this scene's whole bounce run fused?"""
    return (
        scene.kinds_static is not None
        and getattr(scene, "shade_static", False)
        and set(scene.tex_types) <= {TEX_SOLID, TEX_CHECKER, TEX_PERLIN}
    )


def pack_prims_shaded(scene):
    """(PAY_W, P) f32 table: per-primitive geometry + flattened shading
    row (PAY_* layout above)."""
    prims, mats, texs = scene.prims, scene.materials, scene.textures
    data_t = prims.data.T.astype(jnp.float32)  # (12, P)
    P = prims.kind.shape[0]
    tex = mats.tex[prims.mat]
    tkind = texs.kind[tex]
    is_ck = tkind == TEX_CHECKER
    child = texs.child[tex]  # (P, 2)
    odd = jnp.where(is_ck, child[:, 0], 0)
    even = jnp.where(is_ck, child[:, 1], 0)
    rows = [
        prims.kind.astype(jnp.float32),             # 12
        prims.aux.astype(jnp.float32),              # 13
        prims.mat.astype(jnp.float32),              # 14
        jnp.zeros((P,), jnp.float32),               # 15
        mats.kind[prims.mat].astype(jnp.float32),   # 16 PAY_MKIND
        mats.fuzz[prims.mat],                       # 17 PAY_FUZZ
        mats.ir[prims.mat],                         # 18 PAY_IR
        tkind.astype(jnp.float32),                  # 19 PAY_TKIND
        texs.scale[tex],                            # 20 PAY_TSCALE
    ]
    color = texs.color[tex].T                       # 21-23
    oddc = jnp.where(is_ck[None, :], texs.color[odd].T, 0.0)   # 24-26
    evenc = jnp.where(is_ck[None, :], texs.color[even].T, 0.0)  # 27-29
    pad = jnp.zeros((PAY_W - PAY_EVEN - 3, P), jnp.float32)
    return jnp.concatenate(
        [data_t, jnp.stack(rows), color, oddc, evenc, pad], axis=0
    )


# residual `flags` bit layout (custom VJP)
FLG_HIT = 1
FLG_FRONT = 2
FLG_CONT = 4
FLG_REFLECT = 8       # dielectric chose reflect
FLG_SINES_NEG = 16    # checker picked the odd child
FLG_SEL_L = 32
FLG_SEL_M = 64
FLG_SEL_D = 128
FLG_LIGHT_ON = 256    # front-face light emission fired
FLG_COS_CLAMP = 512   # dielectric cos_t hit the min(.,1) clamp
FLG_REFR_ZERO = 1024  # refract safe_sqrt at <= 0 (zero gradient)
FLG_L_NEG = 2048      # refract 1-|perp|^2 < 0 (abs() flips the sign)
FLG_IS_CK = 4096      # winning prim's texture is a checker
FLG_ALIVE = 8192      # lane was alive ENTERING the bounce
# bits 16+ carry the winning primitive index (max(best_i, 0) << 16):
# the backward's one-hot contraction masks by FLG_HIT, so the -1 miss
# sentinel never needs distinguishing from prim 0
FLG_BESTI_SHIFT = 16


def static_sweep(kinds, s, o, d, t_min, shade_rows=()):
    """Unrolled closest-hit sweep over statically typed primitives.

    ``kinds``: static ((kind, aux), ...) per primitive; ``s(row, p)``
    returns table entry ``row`` of primitive ``p`` (a scalar);
    ``o``/``d``: component triples of equal-shape arrays.  Each
    primitive compiles to exactly its own formula — no masked 3-way
    dispatch — with the shrinking ``best_t`` as t_max and a strict
    ``t < best_t`` update, like the reference's list scan.

    Returns (best_t, best_i (-1 on miss), outward normal triple of the
    winner, the winner's 1/r (0 for rect/triangle winners), and the
    winner's table entries for each row in ``shade_rows``).
    """
    ox, oy, oz = o
    dx, dy, dz = d
    shape = ox.shape
    a = dx * dx + dy * dy + dz * dz

    best_t = jnp.full(shape, T_MISS, jnp.float32)
    best_i = jnp.full(shape, -1, jnp.int32)
    wnx = jnp.zeros(shape, jnp.float32)
    wny = jnp.zeros(shape, jnp.float32)
    wnz = jnp.zeros(shape, jnp.float32)
    w_invr = jnp.zeros(shape, jnp.float32)
    shade = [jnp.zeros(shape, jnp.float32) for _ in shade_rows]

    for p, (kind, aux) in enumerate(kinds):
        if kind == PRIM_SPHERE:
            cx, cy, cz, r = s(0, p), s(1, p), s(2, p), s(3, p)
            ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
            half_b = dx * ocx + dy * ocy + dz * ocz
            c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
            dis = half_b * half_b - a * c
            sqrtd = jnp.sqrt(jnp.maximum(dis, 0.0))
            # true division (not reciprocal-multiply), like the jnp
            # sweep in ops/intersect.py
            root1 = (-half_b - sqrtd) / a
            root2 = (-half_b + sqrtd) / a
            ok1 = (root1 >= t_min) & (root1 <= best_t)
            ok2 = (root2 >= t_min) & (root2 <= best_t)
            t = jnp.where(ok1, root1, root2)
            valid = (dis >= 0.0) & (ok1 | ok2)
            inv_r = 1.0 / r
            nx = (ox + t * dx - cx) * inv_r
            ny = (oy + t * dy - cy) * inv_r
            nz = (oz + t * dz - cz) * inv_r
        elif kind == PRIM_RECT:
            k, a0, b0, a1, b1, sgn = (s(j, p) for j in range(6))
            fa, fb = _RECT_FREE[aux]
            t = (k - o[aux]) / d[aux]
            av = o[fa] + t * d[fa]
            bv = o[fb] + t * d[fb]
            valid = (
                (t >= t_min) & (t <= best_t)
                & (av >= a0) & (av <= a1) & (bv >= b0) & (bv <= b1)
            )
            comp = [jnp.zeros(shape, jnp.float32)] * 3
            comp[aux] = jnp.full(shape, 1.0, jnp.float32) * sgn
            nx, ny, nz = comp
        elif kind == PRIM_TRIANGLE:
            p1x, p1y, p1z = s(0, p), s(1, p), s(2, p)
            e1x, e1y, e1z = s(3, p), s(4, p), s(5, p)
            e2x, e2y, e2z = s(6, p), s(7, p), s(8, p)
            pvx = dy * e2z - dz * e2y
            pvy = dz * e2x - dx * e2z
            pvz = dx * e2y - dy * e2x
            det = e1x * pvx + e1y * pvy + e1z * pvz
            inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-30, det, 1.0)
            tvx, tvy, tvz = ox - p1x, oy - p1y, oz - p1z
            uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
            qvx = tvy * e1z - tvz * e1y
            qvy = tvz * e1x - tvx * e1z
            qvz = tvx * e1y - tvy * e1x
            vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det
            t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
            valid = (
                (det >= TRI_DET_EPS)
                & (uu >= 0.0) & (uu <= 1.0) & (vv >= 0.0) & (uu + vv <= 1.0)
                & (t >= t_min) & (t <= best_t)
            )
            ones = jnp.full(shape, 1.0, jnp.float32)
            nx, ny, nz = ones * s(9, p), ones * s(10, p), ones * s(11, p)
        else:
            raise ValueError(f"unknown static kind {kind}")

        upd = valid & (t < best_t)
        best_t = jnp.where(upd, t, best_t)
        best_i = jnp.where(upd, np.int32(p), best_i)
        wnx = jnp.where(upd, nx, wnx)
        wny = jnp.where(upd, ny, wny)
        wnz = jnp.where(upd, nz, wnz)
        w_invr = jnp.where(upd, inv_r if kind == PRIM_SPHERE else 0.0,
                           w_invr)
        shade = [jnp.where(upd, s(row, p), acc)
                 for row, acc in zip(shade_rows, shade)]
    return best_t, best_i, (wnx, wny, wnz), w_invr, shade


# the 13 wavefront state columns, in body order (al is f32 0/1),
# then the 6 uniform columns
_COL_KEYS = ("o0", "o1", "o2", "d0", "d1", "d2", "t0", "t1", "t2",
             "r0", "r1", "r2", "al")
_U_KEYS = ("su0", "su1", "bu0", "bu1", "bu2", "cn")
_RES_KEYS = ("t", "nx", "ny", "nz", "v0", "v1", "v2", "ratio", "invr",
             "flags")


def bounce_body(kinds, mat_types, tex_types, t_min, want_residuals,
                s, bg, seed, x):
    """One whole bounce on equal-shape per-lane arrays.

    ``x``: dict of the 13 state columns (_COL_KEYS) and 6 uniform
    columns (_U_KEYS); ``s(row, p)``: packed-table scalar reader
    (pack_prims_shaded layout); ``bg``: background triple of scalars;
    ``seed``: perlin seed scalar.  Returns the 13 output columns in
    _COL_KEYS order, followed by the 10 residual columns (_RES_KEYS)
    when ``want_residuals``.
    """
    ox, oy, oz = x["o0"], x["o1"], x["o2"]
    dx, dy, dz = x["d0"], x["d1"], x["d2"]
    alive = x["al"] > 0.5
    shape = ox.shape
    a = dx * dx + dy * dy + dz * dz

    acc_rows = (PAY_MKIND, PAY_FUZZ, PAY_IR, PAY_TKIND, PAY_TSCALE,
                PAY_COLOR, PAY_COLOR + 1, PAY_COLOR + 2,
                PAY_ODD, PAY_ODD + 1, PAY_ODD + 2,
                PAY_EVEN, PAY_EVEN + 1, PAY_EVEN + 2)
    best_t, best_i, (wnx, wny, wnz), w_invr, shade = static_sweep(
        kinds, s, (ox, oy, oz), (dx, dy, dz), t_min, acc_rows
    )
    (mk, fz, ir_, tk, ts,
     c0, c1, c2, od0, od1, od2, ev0, ev1, ev2) = shade

    hit = (best_i >= 0) & alive
    t = jnp.where(best_i >= 0, best_t, 1.0)  # finite t for miss lanes

    # ---- hit record (front-face flip, geometry.rs:29-41) ------------
    front = dx * wnx + dy * wny + dz * wnz < 0.0
    flip = jnp.where(front, 1.0, -1.0)
    nx, ny, nz = wnx * flip, wny * flip, wnz * flip
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz

    def flag(mask, bit):
        return jnp.where(mask, np.int32(bit), np.int32(0))

    flags = flag(hit, FLG_HIT) + flag(front, FLG_FRONT)

    # ---- texture value (textures.py eval_texture semantics) ---------
    v0, v1, v2 = c0, c1, c2  # TEX_SOLID
    if TEX_CHECKER in tex_types:
        sines = jnp.sin(ts * px) * jnp.sin(ts * py) * jnp.sin(ts * pz)
        is_ck = tk == float(TEX_CHECKER)
        pick = sines < 0.0
        flags = (flags + flag(is_ck & pick, FLG_SINES_NEG)
                 + flag(is_ck, FLG_IS_CK))
        v0 = jnp.where(is_ck, jnp.where(pick, od0, ev0), v0)
        v1 = jnp.where(is_ck, jnp.where(pick, od1, ev1), v1)
        v2 = jnp.where(is_ck, jnp.where(pick, od2, ev2), v2)
    if TEX_PERLIN in tex_types:
        gray = marble_planes(px, py, pz, seed, ts)
        is_pl = tk == float(TEX_PERLIN)
        v0 = jnp.where(is_pl, gray, v0)
        v1 = jnp.where(is_pl, gray, v1)
        v2 = jnp.where(is_pl, gray, v2)

    # ---- emitted + background banking (ray.rs:26,40) -----------------
    thx, thy, thz = x["t0"], x["t1"], x["t2"]
    rdx, rdy, rdz = x["r0"], x["r1"], x["r2"]
    miss = alive & jnp.logical_not(hit)
    bg0, bg1, bg2 = bg
    rdx = rdx + jnp.where(miss, thx * bg0, 0.0)
    rdy = rdy + jnp.where(miss, thy * bg1, 0.0)
    rdz = rdz + jnp.where(miss, thz * bg2, 0.0)
    if MAT_LIGHT in mat_types:
        em_on = hit & (mk == float(MAT_LIGHT)) & front
        flags = flags + flag(em_on, FLG_LIGHT_ON)
        rdx = rdx + jnp.where(em_on, thx * v0, 0.0)
        rdy = rdy + jnp.where(em_on, thy * v1, 0.0)
        rdz = rdz + jnp.where(em_on, thz * v2, 0.0)

    # ---- scatter (materials.py op-for-op) ----------------------------
    did = jnp.zeros(shape, bool)
    sdx = jnp.zeros(shape, jnp.float32)
    sdy = jnp.zeros(shape, jnp.float32)
    sdz = jnp.zeros(shape, jnp.float32)
    at0 = jnp.zeros(shape, jnp.float32)
    at1 = jnp.zeros(shape, jnp.float32)
    at2 = jnp.zeros(shape, jnp.float32)

    need_unit = (MAT_METAL in mat_types) or (MAT_DIELECTRIC in mat_types)
    if need_unit:
        inv_len = 1.0 / jnp.sqrt(jnp.maximum(a, _SAFE_EPS))
        ux, uy, uz = dx * inv_len, dy * inv_len, dz * inv_len

    # ---- RNG transforms (sampling.on/in_unit_sphere_from_u) ---------
    # Uniforms in, directions here: the trig runs per lane inside the
    # bounce, so the values are the same at every wavefront width and
    # stage split.
    if MAT_LAMBERTIAN in mat_types:
        s_z = 2.0 * x["su0"] - 1.0
        s_phi = (2.0 * np.float32(np.pi)) * x["su1"]
        s_r = jnp.sqrt(jnp.maximum(1.0 - s_z * s_z, 0.0))
        sph_x = s_r * jnp.cos(s_phi)
        sph_y = s_r * jnp.sin(s_phi)
        sph_z = s_z
    if MAT_METAL in mat_types:
        b_z = 2.0 * x["bu0"] - 1.0
        b_phi = (2.0 * np.float32(np.pi)) * x["bu1"]
        b_rho = jnp.sqrt(jnp.maximum(1.0 - b_z * b_z, 0.0))
        b_s = jnp.cbrt(x["bu2"])
        ball_x = b_rho * jnp.cos(b_phi) * b_s
        ball_y = b_rho * jnp.sin(b_phi) * b_s
        ball_z = b_z * b_s

    if MAT_LAMBERTIAN in mat_types:
        dlx = nx + sph_x
        dly = ny + sph_y
        dlz = nz + sph_z
        nz_mask = (
            (jnp.abs(dlx) < NEAR_ZERO) & (jnp.abs(dly) < NEAR_ZERO)
            & (jnp.abs(dlz) < NEAR_ZERO)
        )
        dlx = jnp.where(nz_mask, nx, dlx)
        dly = jnp.where(nz_mask, ny, dly)
        dlz = jnp.where(nz_mask, nz, dlz)
        sel = mk == float(MAT_LAMBERTIAN)
        flags = flags + flag(sel, FLG_SEL_L)
        did = did | sel
        sdx = jnp.where(sel, dlx, sdx)
        sdy = jnp.where(sel, dly, sdy)
        sdz = jnp.where(sel, dlz, sdz)
        at0 = jnp.where(sel, v0, at0)
        at1 = jnp.where(sel, v1, at1)
        at2 = jnp.where(sel, v2, at2)

    if MAT_METAL in mat_types:
        dn = ux * nx + uy * ny + uz * nz
        rfx = ux - 2.0 * dn * nx
        rfy = uy - 2.0 * dn * ny
        rfz = uz - 2.0 * dn * nz
        ok = rfx * nx + rfy * ny + rfz * nz > 0.0
        sel = mk == float(MAT_METAL)
        flags = flags + flag(sel, FLG_SEL_M)
        did = did | (sel & ok)
        sdx = jnp.where(sel, rfx + fz * ball_x, sdx)
        sdy = jnp.where(sel, rfy + fz * ball_y, sdy)
        sdz = jnp.where(sel, rfz + fz * ball_z, sdz)
        at0 = jnp.where(sel, v0, at0)
        at1 = jnp.where(sel, v1, at1)
        at2 = jnp.where(sel, v2, at2)

    ratio = jnp.ones(shape, jnp.float32)
    if MAT_DIELECTRIC in mat_types:
        ratio = jnp.where(front, 1.0 / ir_, ir_)
        raw_cos = -(ux * nx + uy * ny + uz * nz)
        cos_t = jnp.minimum(raw_cos, 1.0)
        sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
        cannot = ratio * sin_t > 1.0
        r0 = ((1.0 - ratio) / (1.0 + ratio)) ** 2
        one_c = 1.0 - cos_t
        refl_p = r0 + (1.0 - r0) * one_c ** 5
        choose_reflect = cannot | (refl_p > x["cn"])
        dnu = ux * nx + uy * ny + uz * nz
        rfx = ux - 2.0 * dnu * nx
        rfy = uy - 2.0 * dnu * ny
        rfz = uz - 2.0 * dnu * nz
        # refract (vec3.rs:118-127 via vecmath.refract)
        opx = ratio * (ux + cos_t * nx)
        opy = ratio * (uy + cos_t * ny)
        opz = ratio * (uz + cos_t * nz)
        plen = jnp.abs(1.0 - (opx * opx + opy * opy + opz * opz))
        raw_l = 1.0 - (opx * opx + opy * opy + opz * opz)
        # vecmath.safe_sqrt: 0 at <= 0
        par = -jnp.where(plen <= 0.0, 0.0,
                         jnp.sqrt(jnp.where(plen <= 0.0, 1.0, plen)))
        rrx = opx + par * nx
        rry = opy + par * ny
        rrz = opz + par * nz
        ddx = jnp.where(choose_reflect, rfx, rrx)
        ddy = jnp.where(choose_reflect, rfy, rry)
        ddz = jnp.where(choose_reflect, rfz, rrz)
        sel = mk == float(MAT_DIELECTRIC)
        flags = (flags + flag(sel, FLG_SEL_D)
                 + flag(choose_reflect, FLG_REFLECT)
                 + flag(raw_cos >= 1.0, FLG_COS_CLAMP)
                 + flag(plen <= 0.0, FLG_REFR_ZERO)
                 + flag(raw_l < 0.0, FLG_L_NEG))
        did = did | sel
        sdx = jnp.where(sel, ddx, sdx)
        sdy = jnp.where(sel, ddy, sdy)
        sdz = jnp.where(sel, ddz, sdz)
        at0 = jnp.where(sel, 1.0, at0)
        at1 = jnp.where(sel, 1.0, at1)
        at2 = jnp.where(sel, 1.0, at2)

    # ---- state commit (integrator._bounce_step tail) -----------------
    cont = hit & did
    out = (
        jnp.where(cont, px, ox), jnp.where(cont, py, oy),
        jnp.where(cont, pz, oz),
        jnp.where(cont, sdx, dx), jnp.where(cont, sdy, dy),
        jnp.where(cont, sdz, dz),
        jnp.where(cont, thx * at0, thx), jnp.where(cont, thy * at1, thy),
        jnp.where(cont, thz * at2, thz),
        rdx, rdy, rdz,
        cont.astype(jnp.float32),
    )
    if not want_residuals:
        return out
    # what the hand-written VJP (_bounce_grads) consumes
    flags = (flags + flag(cont, FLG_CONT) + flag(alive, FLG_ALIVE)
             + (jnp.maximum(best_i, 0) << FLG_BESTI_SHIFT))
    return out + (t, nx, ny, nz, v0, v1, v2, ratio, flip * w_invr, flags)


def _res_dtype():
    """Residual dtype: f32 (default) or bf16 (RPT_FBD_RES=bf16,
    opt-in — halves the residual round-trip under a documented
    gradient-accuracy contract; flags stay int32 either way)."""
    return (jnp.bfloat16 if os.environ.get("RPT_FBD_RES") == "bf16"
            else jnp.float32)


@functools.partial(jax.jit, static_argnames=("kinds", "mat_types",
                                             "tex_types", "t_min",
                                             "want_residuals"))
def _fused_bounce_cols(packed, bg, seed, cols, su0, su1, bu0, bu1, bu2,
                       coin, *, kinds, mat_types, tex_types, t_min,
                       want_residuals=False):
    """Column-native fused bounce: 13 (R,) state columns + 6 (R,)
    uniform columns in, 13 (R,) columns out (+ the (R,) residual
    columns, keyed by _RES_KEYS, when ``want_residuals``)."""
    x = dict(cols, su0=su0, su1=su1, bu0=bu0, bu1=bu1, bu2=bu2, cn=coin)
    outs = bounce_body(
        kinds, mat_types, tex_types, t_min, want_residuals,
        lambda row, p: packed[row, p], (bg[0], bg[1], bg[2]),
        seed.reshape(()), x,
    )
    rdt = _res_dtype()
    outs = tuple(outs[:13]) + tuple(
        v.astype(rdt) if v.dtype == jnp.float32 else v for v in outs[13:]
    )
    cols_out = dict(zip(_COL_KEYS, outs[:13]))
    if not want_residuals:
        return cols_out
    return cols_out, dict(zip(_RES_KEYS, outs[13:]))


def fused_bounce_apply(scene, o, d, thr, rad, alive, sphere_u,
                       ball_u, coin, background, t_min):
    """Run one full bounce fused, on (R, 3) arrays (the regen wavefront
    and trace_resume keep this interface; the hot diff/nondiff scans
    use the column carry directly).

    ``sphere_u`` (R, 2) and ``ball_u`` (R, 3) are RAW UNIFORMS —
    the on/in-unit-sphere transforms run in the fused body.

    Returns (o', d', thr', rad', alive') with the same semantics as the
    composed search_and_record + shade + commit path in
    integrator._bounce_step (russian roulette NOT applied — callers
    keep it in XLA, where its lax.cond belongs)."""
    cols = dict(zip(_COL_KEYS, (
        o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
        thr[:, 0], thr[:, 1], thr[:, 2], rad[:, 0], rad[:, 1],
        rad[:, 2], alive.astype(jnp.float32),
    )))
    c = _fused_bounce_cols(
        pack_prims_shaded(scene), jnp.asarray(background, jnp.float32),
        jnp.asarray(scene.textures.perlin_seed, jnp.uint32), cols,
        sphere_u[:, 0], sphere_u[:, 1], ball_u[:, 0], ball_u[:, 1],
        ball_u[:, 2], coin, kinds=scene.kinds_static,
        mat_types=scene.mat_types, tex_types=scene.tex_types,
        t_min=float(t_min),
    )
    return (
        jnp.stack([c["o0"], c["o1"], c["o2"]], 1),
        jnp.stack([c["d0"], c["d1"], c["d2"]], 1),
        jnp.stack([c["t0"], c["t1"], c["t2"]], 1),
        jnp.stack([c["r0"], c["r1"], c["r2"]], 1),
        c["al"] > 0.5,
    )


# ---------------------------------------------------------------------------
# differentiable path: fused forward + hand-written closed-form backward
# ---------------------------------------------------------------------------
#
# The custom VJP computes exactly what reverse-mode AD computes through
# the XLA diff bounce under the DEFAULT estimator (integrator._bounce_step
# with RPT_DIFF_T=analytic, detached sampling):
#
# * discrete events (hit/idx, material choice, dielectric coin, metal
#   grazing absorb, checker pick, near-zero fallback) are detached;
# * t is the implicit-function linearization (integrator._analytic_t):
#   dt/do = -n/(n.d), dt/dd = -t n/(n.d) — any nonzero multiple of the
#   surface normal works (scale and sign cancel in the ratio), so the
#   body's saved flipped unit normal serves;
# * the sphere's shading normal is differentiable through the hit point
#   (record_from_rows: n = flip*(point-c)/r, so dn/dpoint = flip/r);
#   rect/triangle shading normals are constants;
# * texture-value gradients route to the packed table's color rows
#   (solid / checker-odd / checker-even by the saved pick flags);
#   pack_prims_shaded is plain differentiable gather code, so XLA
#   carries d_packed on to scene.textures.color (the DiffParams leaf)
#   automatically.
#
# Like the XLA analytic-t default, hit-distance geometry gradients
# (d/d prims.data) are dropped — prims.data is not a DiffParams leaf
# (integrator.trace docstring documents the limitation).
#
# Supported: solid + checker-of-solids textures.  Perlin's
# d(value)/d(point) term is not implemented — scenes with perlin keep
# the XLA diff path (fused_bounce_diff_ok gates).


def fused_bounce_diff_ok(scene) -> bool:
    """Static routing for the differentiable fused bounce."""
    return (
        fused_bounce_ok(scene)
        and set(scene.tex_types) <= {TEX_SOLID, TEX_CHECKER}
        and os.environ.get("RPT_DIFF_T", "analytic") == "analytic"
    )


@functools.lru_cache(maxsize=None)
def _make_fused_bounce_vjp(kinds, mat_types, tex_types, t_min):
    """Column-native custom VJP: ``bounce(cols, su0, su1, bu0, bu1,
    bu2, coin, packed, bg) -> cols'`` where ``cols`` is the 13-column
    state dict (_COL_KEYS)."""
    P = len(kinds)

    def run(cols, su0, su1, bu0, bu1, bu2, coin, packed, bg, want_res):
        seed = jnp.zeros((1,), jnp.uint32)  # perlin is gated out here
        return _fused_bounce_cols(
            packed, bg, seed, cols, su0, su1, bu0, bu1, bu2, coin,
            kinds=kinds, mat_types=mat_types, tex_types=tex_types,
            t_min=t_min, want_residuals=want_res,
        )

    @jax.custom_vjp
    def bounce(cols, su0, su1, bu0, bu1, bu2, coin, packed, bg):
        return run(cols, su0, su1, bu0, bu1, bu2, coin, packed, bg,
                   False)

    def fwd(cols, su0, su1, bu0, bu1, bu2, coin, packed, bg):
        out, res = run(cols, su0, su1, bu0, bu1, bu2, coin, packed, bg,
                       True)
        d = (cols["d0"], cols["d1"], cols["d2"])
        thr = (cols["t0"], cols["t1"], cols["t2"])
        return out, (d, thr, bg, res, packed)

    def bwd(saved, cots):
        d, thr, bg, res, packed = saved
        zr = jnp.zeros_like(d[0])
        g_o2 = (cots["o0"], cots["o1"], cots["o2"])
        g_d2 = (cots["d0"], cots["d1"], cots["d2"])
        g_thr2 = (cots["t0"], cots["t1"], cots["t2"])
        g_rad2 = (cots["r0"], cots["r1"], cots["r2"])
        g_o, g_d, g_thr, gp, g_bg = _bounce_grads(
            res, d, thr, bg, g_o2, g_d2, g_thr2, g_rad2, packed, P,
            mat_types,
        )
        g_cols = dict(zip(_COL_KEYS, (
            g_o[0], g_o[1], g_o[2], g_d[0], g_d[1], g_d[2],
            g_thr[0], g_thr[1], g_thr[2],
            g_rad2[0], g_rad2[1], g_rad2[2], zr,
        )))
        return (g_cols, zr, zr, zr, zr, zr, zr,
                _psum_to_replicated(gp, packed),
                _psum_to_replicated(g_bg, bg))

    bounce.defvjp(fwd, bwd)
    return bounce


def _bounce_grads(res, d, thr, bg, g_o2, g_d2, g_thr2, g_rad2, packed,
                  P, mat_types):
    """One bounce's closed-form input cotangents, shared by the
    per-bounce custom VJP and the whole-scan VJP (fused_scan_trace):
    (g_o, g_d, g_thr column triples, d_packed, d_bg)."""
    flags = res["flags"]
    best_i = flags >> FLG_BESTI_SHIFT
    hit = _bit(flags, FLG_HIT)
    cont = _bit(flags, FLG_CONT)
    sines_neg = _bit(flags, FLG_SINES_NEG)
    sel_l = _bit(flags, FLG_SEL_L) & cont
    sel_m = _bit(flags, FLG_SEL_M) & cont
    light_on = _bit(flags, FLG_LIGHT_ON)
    is_ck = _bit(flags, FLG_IS_CK)
    miss = _bit(flags, FLG_ALIVE) & ~hit

    g_o, g_d, g_thr = _bwd_xla(
        res, d, bg, g_o2, g_d2, g_thr2, g_rad2, mat_types,
    )

    # ---- small reductions (fuse with the contraction below) ------
    missf = miss.astype(jnp.float32)
    g_bg = jnp.stack([
        jnp.sum(missf * thr[c] * g_rad2[c]) for c in range(3)
    ])
    lmf = (sel_l | sel_m).astype(jnp.float32)
    lonf = light_on.astype(jnp.float32)
    g_val = [
        lmf * thr[c] * g_thr2[c] + lonf * thr[c] * g_rad2[c]
        for c in range(3)
    ]

    # ---- packed color rows: ONE one-hot contraction -----------------
    onehot = (
        (best_i[:, None] == jnp.arange(P, dtype=jnp.int32)[None, :])
        & hit[:, None]
    ).astype(jnp.float32)
    targets = (
        (PAY_COLOR, hit & ~is_ck),
        (PAY_ODD, is_ck & sines_neg),
        (PAY_EVEN, is_ck & ~sines_neg),
    )
    gv9 = jnp.stack(
        [g_val[c] * mask.astype(jnp.float32)
         for _, mask in targets for c in range(3)], axis=1
    )                                                     # (R, 9)
    # RPT_FBD_RES=bf16 extends the residual-accuracy contract to the
    # texture-grad contraction: bf16 operands (the one-hot is exact in
    # bf16; gv9 rounds — same ~1e-2 normalized class as the bf16
    # residuals)
    if _res_dtype() == jnp.bfloat16:
        contrib = jnp.einsum(
            "rp,rc->pc", onehot.astype(jnp.bfloat16),
            gv9.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        ).astype(jnp.float32)
    else:
        # HIGHEST: a float32 matmul at default precision may run in
        # TF32 (10-bit mantissa) on the GPU; at HIGHEST the one-hot
        # contraction is exact per term, like ops/table.lookup
        contrib = jnp.einsum(
            "rp,rc->pc", onehot, gv9,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )                                                 # (P, 9)
    gp = jnp.zeros_like(packed)
    for j, (row0, _) in enumerate(targets):
        gp = gp.at[row0:row0 + 3].add(contrib[:, 3 * j:3 * j + 3].T)
    return g_o, g_d, g_thr, gp, g_bg


def _bit(flags, b):
    return (flags & b) != 0


def _psum_to_replicated(g, primal):
    """Collapse a shard-VARYING cotangent onto a REPLICATED primal.

    Under shard_map with check_vma (the default), a custom_vjp's bwd
    must EXPLICITLY psum the per-shard partial gradients of a
    replicated input (packed table, background) — jax's shard_map
    transpose no longer inserts the collective for custom VJPs, it
    type-checks that the returned cotangent's varying-axes set matches
    the input's.  The psum set is derived from the vma types, so this
    is a no-op outside shard_map and exact inside (the replicated
    gradient IS the sum of shard partials, same as jax inserts for
    non-custom primitives)."""
    want = set(jax.typeof(primal).vma)
    extra = tuple(sorted(set(jax.typeof(g).vma) - want))
    return jax.lax.psum(g, extra) if extra else g


def _bwd_xla(res, d, bg, g_o2, g_d2, g_thr2, g_rad2, mat_types):
    """The per-lane backward chains of the closed-form VJP, left to
    XLA's fuser: residual + cotangent columns in, (g_o, g_d, g_thr)
    column triples out (internally (R, 3) for brevity)."""
    d = jnp.stack(d, 1)
    g_o2 = jnp.stack(g_o2, 1)
    g_d2 = jnp.stack(g_d2, 1)
    g_thr2 = jnp.stack(g_thr2, 1)
    g_rad2 = jnp.stack(g_rad2, 1)

    def up(col):
        # residuals may be bf16 (RPT_FBD_RES=bf16) — upcast
        return col.astype(jnp.float32) if col.dtype != jnp.int32 else col

    t = up(res["t"])
    n = jnp.stack([up(res["nx"]), up(res["ny"]), up(res["nz"])], 1)
    val = jnp.stack([up(res["v0"]), up(res["v1"]), up(res["v2"])], 1)
    ratio = up(res["ratio"])
    invr = up(res["invr"])
    flags = res["flags"]

    hit = _bit(flags, FLG_HIT)
    cont = _bit(flags, FLG_CONT)
    choose_reflect = _bit(flags, FLG_REFLECT)
    sel_l = _bit(flags, FLG_SEL_L) & cont
    sel_m = _bit(flags, FLG_SEL_M) & cont
    sel_d = _bit(flags, FLG_SEL_D) & cont
    light_on = _bit(flags, FLG_LIGHT_ON)
    cos_clamp = _bit(flags, FLG_COS_CLAMP)
    refr_zero = _bit(flags, FLG_REFR_ZERO)
    l_neg = _bit(flags, FLG_L_NEG)
    miss = _bit(flags, FLG_ALIVE) & ~hit

    def m(mask):
        return mask[:, None].astype(jnp.float32)

    def dot(a, b):
        return jnp.sum(a * b, axis=-1, keepdims=True)

    a = jnp.sum(d * d, axis=-1, keepdims=True)
    sa = jnp.sqrt(jnp.maximum(a, _SAFE_EPS))
    u = d / sa
    rr = ratio[:, None]

    g_dir = m(cont) * g_d2
    g_n = m(sel_l) * g_dir  # lambertian: dir = n + sph (or n)
    g_u = jnp.zeros_like(d)

    refl_m = sel_m | (sel_d & choose_reflect)
    if (MAT_METAL in mat_types) or (MAT_DIELECTRIC in mat_types):
        s = dot(u, n)
        gr = m(refl_m) * g_dir
        ngr = dot(n, gr)
        g_u = g_u + gr - 2.0 * n * ngr
        g_n = g_n - 2.0 * (u * ngr + s * gr)

    if MAT_DIELECTRIC in mat_types:
        rm = sel_d & ~choose_reflect
        gout = m(rm) * g_dir
        raw_cos = -dot(u, n)
        cos = jnp.minimum(raw_cos, 1.0)
        perp = rr * (u + cos * n)
        abs_l = jnp.abs(1.0 - jnp.sum(perp * perp, -1, keepdims=True))
        s_par = jnp.where(refr_zero[:, None], 0.0, jnp.sqrt(abs_l))
        g_spar = -dot(n, gout)
        g_n = g_n - s_par * gout
        g_absl = jnp.where(
            refr_zero[:, None], 0.0,
            g_spar / jnp.maximum(2.0 * s_par, 1e-30),
        )
        sign = jnp.where(l_neg[:, None], -1.0, 1.0)
        g_perp = gout - 2.0 * perp * (sign * g_absl)
        g_u = g_u + rr * g_perp
        g_n = g_n + rr * cos * g_perp
        g_cos = jnp.where(
            cos_clamp[:, None], 0.0, rr * dot(n, g_perp)
        )
        g_u = g_u - n * g_cos
        g_n = g_n - u * g_cos

    g_d = m(~cont) * g_d2 + (g_u - u * dot(u, g_u)) / sa

    att = jnp.where(m(sel_l | sel_m), val, 1.0)
    g_thr = (
        jnp.where(m(cont), att * g_thr2, g_thr2)
        + m(miss) * bg[None, :] * g_rad2
        + m(light_on) * val * g_rad2
    )

    g_point = m(cont) * g_o2 + invr[:, None] * g_n
    g_t = dot(d, g_point)
    g_o = m(~cont) * g_o2 + g_point
    g_d = g_d + t[:, None] * g_point
    den = dot(n, d)
    den = jnp.where(jnp.abs(den) < 1e-30, 1.0, den)
    g_o = g_o + g_t * (-n / den)
    g_d = g_d + g_t * (-t[:, None] * n / den)
    return (
        (g_o[:, 0], g_o[:, 1], g_o[:, 2]),
        (g_d[:, 0], g_d[:, 1], g_d[:, 2]),
        (g_thr[:, 0], g_thr[:, 1], g_thr[:, 2]),
    )


def fused_bounce_cols_step(scene, cols, su0, su1, bu0, bu1, bu2, coin,
                           background, t_min, differentiable):
    """Column-native bounce for the hot scan carries (integrator
    _trace_fused_cols): 13-column state dict + 6 uniform columns in,
    columns out.  ``differentiable`` routes through the custom VJP
    (detached-sampling gradients to o/d/thr/rad, texture colors via
    ``packed``, and background)."""
    bg = jnp.asarray(background, jnp.float32)
    if differentiable:
        packed = pack_prims_shaded(scene)
        bounce = _make_fused_bounce_vjp(
            scene.kinds_static, scene.mat_types, scene.tex_types,
            float(t_min),
        )
        return bounce(cols, su0, su1, bu0, bu1, bu2, coin, packed, bg)
    packed = jax.lax.stop_gradient(pack_prims_shaded(scene))
    seed = jnp.asarray(scene.textures.perlin_seed, jnp.uint32)
    return _fused_bounce_cols(
        packed, bg, seed, cols, su0, su1, bu0, bu1, bu2, coin,
        kinds=scene.kinds_static, mat_types=scene.mat_types,
        tex_types=scene.tex_types, t_min=float(t_min),
    )


def fused_bounce_diff_apply(scene, o, d, thr, rad, alive, sphere_u,
                            ball_u, coin, background, t_min):
    """Differentiable fused bounce (custom VJP), (R, 3) AoS wrapper
    over the column-native core.  Same state-update semantics as
    fused_bounce_apply (uniforms in, transforms in the body); gradients
    flow to (o, d, thr, rad), scene.textures.color (via
    pack_prims_shaded), and background."""
    cols = dict(zip(_COL_KEYS, (
        o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
        thr[:, 0], thr[:, 1], thr[:, 2], rad[:, 0], rad[:, 1],
        rad[:, 2], alive.astype(jnp.float32),
    )))
    c = fused_bounce_cols_step(
        scene, cols, sphere_u[:, 0], sphere_u[:, 1], ball_u[:, 0],
        ball_u[:, 1], ball_u[:, 2], coin, background, t_min,
        differentiable=True,
    )
    return (
        jnp.stack([c["o0"], c["o1"], c["o2"]], 1),
        jnp.stack([c["d0"], c["d1"], c["d2"]], 1),
        jnp.stack([c["t0"], c["t1"], c["t2"]], 1),
        jnp.stack([c["r0"], c["r1"], c["r2"]], 1),
        c["al"] > 0.5,
    )


# ---------------------------------------------------------------------------
# whole-scan custom VJP: hand-rolled backward loop over ALL bounces
# ---------------------------------------------------------------------------
#
# The per-bounce custom VJP (above) still leaves the BACKWARD SCHEDULE
# to jax's lax.scan transpose: per bounce it re-marshals 13 cotangent
# columns through the scan carry, saves/restores the closure residuals,
# transposes the roulette lax.cond, and stacks zero cotangents for the
# hoisted uniform xs.  This VJP replaces the whole scan-of-custom-vjps
# with ONE custom_vjp around the entire bounce loop: the forward is the
# same fused-body scan (bitwise-identical primal, incl. roulette and
# stats), the backward is a hand-written reversed lax.scan whose carry
# is exactly (13 cotangent columns, d_packed, d_bg) and whose
# per-bounce body is the shared closed-form _bounce_grads + an
# unconditional roulette transpose (the identity branch saved p=1/act=0,
# so where(act, 1/p, 1) covers both branches with no lax.cond).  Stats
# (segments/occupancy) are detached — same effective gradients as the
# AD path, where their cotangents die at the discrete alive chain.
# RPT_FBD_SCAN=jax restores the lax.scan transpose path.


@functools.lru_cache(maxsize=None)
def _make_fused_scan_vjp(kinds, mat_types, tex_types, t_min,
                         max_bounces, rr_start, stats_slots, unroll):
    P = len(kinds)
    has_rr = rr_start < max_bounces

    def run_body(cols, su0, su1, bu0, bu1, bu2, cn, packed, bg,
                   want_res):
        seed = jnp.zeros((1,), jnp.uint32)  # perlin is gated out here
        return _fused_bounce_cols(
            packed, bg, seed, cols, su0, su1, bu0, bu1, bu2, cn,
            kinds=kinds, mat_types=mat_types, tex_types=tex_types,
            t_min=t_min, want_residuals=want_res,
        )

    def fwd_body(carry, x, packed, bg, want_res):
        cols, seg, occ = carry
        sgf = jax.lax.stop_gradient
        n_alive = jnp.sum(sgf(cols["al"]))
        seg = seg + n_alive
        occ = jax.lax.dynamic_update_slice(
            occ, n_alive[None],
            (jnp.minimum(x["b"], stats_slots - 1),),
        )
        su, bu, cn = x["sphere_u"], x["ball_u"], x["coin"]
        d_in = (cols["d0"], cols["d1"], cols["d2"])
        thr_in = (cols["t0"], cols["t1"], cols["t2"])
        out = run_body(cols, su[:, 0], su[:, 1], bu[:, 0], bu[:, 1],
                         bu[:, 2], cn, packed, bg, want_res)
        cols2, res = out if want_res else (out, None)

        # roulette: op-for-op integrator._trace_fused_cols.bounce_body
        # (same max tree, same division, same cond) + (p, act) saved so
        # the transpose needs no cond: identity saves p=1, act=0
        def roulette(args):
            t0, t1, t2, al = args
            p = jnp.clip(
                jnp.maximum(jnp.maximum(sgf(t0), sgf(t1)), sgf(t2)),
                0.05, 1.0,
            )
            u = x["roulette"]
            act = (al > 0.5) & (u < p)
            t0 = jnp.where(act, t0 / p, t0)
            t1 = jnp.where(act, t1 / p, t1)
            t2 = jnp.where(act, t2 / p, t2)
            al = jnp.where(al > 0.5, act.astype(jnp.float32), al)
            return t0, t1, t2, al, p, act.astype(jnp.float32)

        def ident(args):
            t0, t1, t2, al = args
            return (t0, t1, t2, al, jnp.ones_like(t0),
                    jnp.zeros_like(t0))

        if has_rr:
            t0, t1, t2, al, p, actf = jax.lax.cond(
                x["b"] >= rr_start, roulette, ident,
                (cols2["t0"], cols2["t1"], cols2["t2"], cols2["al"]),
            )
            cols2 = dict(cols2, t0=t0, t1=t1, t2=t2, al=al)
        ys = None
        if want_res:
            ys = dict(res)
            ys.update(d0=d_in[0], d1=d_in[1], d2=d_in[2],
                      ti0=thr_in[0], ti1=thr_in[1], ti2=thr_in[2])
            if has_rr:
                ys.update(rp=p, ract=actf)
        return (cols2, seg, occ), ys

    def run_scan(cols0, packed, bg, draws, want_res):
        zero_scalar = jnp.sum(cols0["o0"] * 0.0)
        occ0 = zero_scalar + jnp.zeros((stats_slots,), jnp.float32)
        xs = dict(draws)
        xs["b"] = jnp.arange(max_bounces, dtype=jnp.int32)
        (colsF, seg, occ), ys = jax.lax.scan(
            lambda c, x: fwd_body(c, x, packed, bg, want_res),
            (cols0, zero_scalar, occ0), xs, unroll=unroll,
        )
        return (colsF, seg, occ), ys

    @jax.custom_vjp
    def scan_all(cols0, packed, bg, draws):
        out, _ = run_scan(cols0, packed, bg, draws, False)
        return out

    def scan_fwd(cols0, packed, bg, draws):
        out, ys = run_scan(cols0, packed, bg, draws, True)
        return out, (ys, packed, bg, draws)

    def scan_bwd(saved, cots):
        ys, packed, bg, draws = saved
        g_colsF, _g_seg, _g_occ = cots  # stats are detached
        zr = jnp.zeros_like(ys["d0"][0])
        # varying-zero scalar: under shard_map (check_vma) the carry's
        # d_packed/d_bg accumulators and the returned draw cotangents
        # must carry the shard-VARYING type their per-bounce updates
        # have — deriving the zero from ys (per-shard data) gives it
        # the right vma; adds exact 0.0 otherwise (same pattern as
        # integrator's zero_scalar)
        zs = jnp.sum(zr)
        g_draws = jax.tree_util.tree_map(
            lambda a: jnp.zeros_like(a) + zs, draws
        )

        def body(carry, y):
            g, gp, gbg = carry
            if has_rr:
                # transpose of thr' = where(act, thr/p, thr): g/p on
                # act lanes — division, not 1/p-then-multiply, so the
                # rounding matches jax's divide transpose exactly
                act = y["ract"] > 0.5
                gt = tuple(
                    jnp.where(act, g[k] / y["rp"], g[k])
                    for k in ("t0", "t1", "t2")
                )
            else:
                gt = (g["t0"], g["t1"], g["t2"])
            res_b = {k: y[k] for k in _RES_KEYS}
            d_b = (y["d0"], y["d1"], y["d2"])
            thr_b = (y["ti0"], y["ti1"], y["ti2"])
            g_o2 = (g["o0"], g["o1"], g["o2"])
            g_d2 = (g["d0"], g["d1"], g["d2"])
            g_rad2 = (g["r0"], g["r1"], g["r2"])
            g_o, g_d, g_thr, gp_b, gbg_b = _bounce_grads(
                res_b, d_b, thr_b, bg, g_o2, g_d2, gt, g_rad2, packed,
                P, mat_types,
            )
            g2 = dict(
                g, o0=g_o[0], o1=g_o[1], o2=g_o[2],
                d0=g_d[0], d1=g_d[1], d2=g_d[2],
                t0=g_thr[0], t1=g_thr[1], t2=g_thr[2],
            )  # rad cotangent passes through; al stays zero
            return (g2, gp + gp_b, gbg + gbg_b), None

        g0 = {k: g_colsF[k] for k in _COL_KEYS}
        g0["al"] = zr
        (gI, gp, gbg), _ = jax.lax.scan(
            body,
            (g0, jnp.zeros_like(packed) + zs, jnp.zeros_like(bg) + zs),
            ys, reverse=True, unroll=unroll,
        )
        return (gI, _psum_to_replicated(gp, packed),
                _psum_to_replicated(gbg, bg), g_draws)

    scan_all.defvjp(scan_fwd, scan_bwd)
    return scan_all


def fused_scan_trace(scene, cols, draws_all, background, t_min,
                     max_bounces, rr_start, stats_slots, unroll=2):
    """Differentiable whole-scan trace for fused-diff scenes.

    ``cols``: 13-column state dict (_COL_KEYS); ``draws_all``: the
    hoisted uniform draws from integrator._precompute_draws (REQUIRED —
    the scan consumes them as xs).  Returns (cols_final, segments,
    occupancy).  Primal is bitwise the _trace_fused_cols scan body;
    gradients flow to cols/scene.textures.color (via packed)/background
    with the same detached-sampling estimator as the per-bounce VJP.
    """
    packed = pack_prims_shaded(scene)
    bg = jnp.asarray(background, jnp.float32)
    scan_all = _make_fused_scan_vjp(
        scene.kinds_static, scene.mat_types, scene.tex_types,
        float(t_min), int(max_bounces), int(rr_start),
        int(stats_slots), int(unroll),
    )
    return scan_all(cols, packed, bg, dict(draws_all))

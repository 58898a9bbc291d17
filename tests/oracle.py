"""Independent f64 numpy path tracer — correctness oracle for tests.

Implements the reference semantics (ray.rs / geometry.rs / material.rs)
directly in numpy, sharing NO code with rust_pathtracer_tpu: scalar-ish
recursion flattened over a sample batch, f64 throughout, numpy RNG with
true rejection sampling.  Used to validate the framework's images
statistically (same scene -> same expected radiance within MC error).
"""

from __future__ import annotations

import numpy as np


# --- scene as plain dicts -------------------------------------------------
# prim: {"type": "sphere"|"rect"|"tri", ...fields..., "mat": mat dict}
# mat:  {"type": "lam"|"metal"|"diel"|"light", "color": (3,), "fuzz": f, "ir": f}
#       color may instead be {"checker": (odd(3,), even(3,), freq)} — the
#       3D sine-lattice checker of texture.rs:38-44 evaluated at the hit
#       point (sign of sin(fx) sin(fy) sin(fz) picks odd/even)


def mat_color(m, p):
    """Albedo/emission at hit points p (R, 3) for a material dict."""
    c = m["color"]
    if isinstance(c, dict) and "checker" in c:
        odd, even, f = c["checker"]
        s = np.sin(f * p[:, 0]) * np.sin(f * p[:, 1]) * np.sin(f * p[:, 2])
        return np.where((s < 0.0)[:, None], np.asarray(odd, float),
                        np.asarray(even, float))
    return np.broadcast_to(np.asarray(c, float), (p.shape[0], 3))


def norm(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-300)


def reflect(v, n):
    return v - 2.0 * np.sum(v * n, -1, keepdims=True) * n


def refract_np(v, n, eta):
    cos = np.minimum(-np.sum(v * n, -1, keepdims=True), 1.0)
    perp = eta[..., None] * (v + cos * n)
    par = -np.sqrt(np.abs(1.0 - np.sum(perp * perp, -1, keepdims=True))) * n
    return perp + par


def hit_prim(prim, o, d, t_min, t_max):
    """Returns (t, normal_outward, front_face_irrelevant-here, u, v); t=inf miss."""
    R = o.shape[0]
    inf = np.full(R, np.inf)
    if prim["type"] == "sphere":
        c, r = np.asarray(prim["center"], float), prim["radius"]
        oc = o - c
        a = np.sum(d * d, -1)
        hb = np.sum(d * oc, -1)
        cc = np.sum(oc * oc, -1) - r * r
        dis = hb * hb - a * cc
        ok = dis >= 0
        sq = np.sqrt(np.maximum(dis, 0))
        r1 = (-hb - sq) / a
        r2 = (-hb + sq) / a
        t = np.where((r1 >= t_min) & (r1 <= t_max), r1,
                     np.where((r2 >= t_min) & (r2 <= t_max), r2, np.inf))
        t = np.where(ok, t, np.inf)
        p = o + t[:, None] * d
        n = (p - c) / r
        return t, n
    if prim["type"] == "rect":
        ax = prim["axis"]  # fixed axis
        free = [i for i in range(3) if i != ax]
        k, a0, a1, b0, b1 = prim["k"], prim["a0"], prim["a1"], prim["b0"], prim["b1"]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (k - o[:, ax]) / d[:, ax]
        av = o[:, free[0]] + t * d[:, free[0]]
        bv = o[:, free[1]] + t * d[:, free[1]]
        ok = (t >= t_min) & (t <= t_max) & (av >= a0) & (av <= a1) & (bv >= b0) & (bv <= b1)
        t = np.where(ok, t, np.inf)
        n = np.zeros((R, 3))
        n[:, ax] = prim["dir"]
        return t, n
    if prim["type"] == "tri":
        p1 = np.asarray(prim["p1"], float)
        e1 = np.asarray(prim["p2"], float) - p1
        e2 = np.asarray(prim["p3"], float) - p1
        pv = np.cross(d, e2)
        det = np.sum(e1 * pv, -1)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / det
        tv = o - p1
        u = np.sum(tv * pv, -1) * inv
        qv = np.cross(tv, e1)
        v = np.sum(d * qv, -1) * inv
        t = np.sum(e2 * qv, -1) * inv
        ok = (det >= 1e-4) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) \
            & (t >= t_min) & (t <= t_max)
        t = np.where(ok, t, np.inf)
        n = np.broadcast_to(np.asarray(prim["normal"], float), (R, 3)).copy()
        return t, n
    raise ValueError(prim["type"])


def rand_unit_vecs(rng, R):
    """Rejection sample in unit sphere then normalize (vec3.rs:41-53)."""
    out = np.zeros((R, 3))
    todo = np.ones(R, bool)
    while todo.any():
        p = rng.uniform(-1, 1, (int(todo.sum()), 3))
        good = np.sum(p * p, -1) < 1.0
        idx = np.flatnonzero(todo)[good]
        out[idx] = p[good]
        todo[idx] = False
    return norm(out)


def rand_in_sphere(rng, R):
    out = np.zeros((R, 3))
    todo = np.ones(R, bool)
    while todo.any():
        p = rng.uniform(-1, 1, (int(todo.sum()), 3))
        good = np.sum(p * p, -1) < 1.0
        idx = np.flatnonzero(todo)[good]
        out[idx] = p[good]
        todo[idx] = False
    return out


def trace_oracle(prims, o, d, background, max_bounces, rng):
    """Iterative equivalent of Ray::color (ray.rs:20-41), f64 numpy."""
    R = o.shape[0]
    thr = np.ones((R, 3))
    rad = np.zeros((R, 3))
    alive = np.ones(R, bool)
    bg = np.asarray(background, float)

    for _ in range(max_bounces):
        if not alive.any():
            break
        best_t = np.full(R, np.inf)
        best_i = np.full(R, -1)
        best_n = np.zeros((R, 3))
        for i, prim in enumerate(prims):
            t, n = hit_prim(prim, o, d, 1e-3, best_t)
            upd = alive & (t < best_t)
            best_t = np.where(upd, t, best_t)
            best_i = np.where(upd, i, best_i)
            best_n = np.where(upd[:, None], n, best_n)

        miss = alive & ~np.isfinite(best_t)
        rad[miss] += thr[miss] * bg
        alive = alive & ~miss

        hit = alive
        if not hit.any():
            break
        p = o + best_t[:, None] * d
        front = np.sum(d * best_n, -1) < 0
        n = np.where(front[:, None], best_n, -best_n)

        new_alive = np.zeros(R, bool)
        for i, prim in enumerate(prims):
            sel = hit & (best_i == i)
            if not sel.any():
                continue
            m = prim["mat"]
            ns = int(sel.sum())
            if m["type"] == "light":
                emit = mat_color(m, p[sel])
                f = front[sel]
                rad[sel] += thr[sel] * emit * f[:, None]
            elif m["type"] == "lam":
                sd_ = n[sel] + rand_unit_vecs(rng, ns)
                deg = np.all(np.abs(sd_) < 1e-8, -1)
                sd_[deg] = n[sel][deg]
                thr[sel] *= mat_color(m, p[sel])
                o[sel] = p[sel]
                d[sel] = sd_
                new_alive[np.flatnonzero(sel)] = True
            elif m["type"] == "metal":
                rd = reflect(norm(d[sel]), n[sel])
                ok = np.sum(rd * n[sel], -1) > 0
                rd = rd + m["fuzz"] * rand_in_sphere(rng, ns)
                thr[sel] *= mat_color(m, p[sel])
                o[sel] = p[sel]
                d[sel] = rd
                new_alive[np.flatnonzero(sel)[ok]] = True
            elif m["type"] == "diel":
                ir = m["ir"]
                ratio = np.where(front[sel], 1.0 / ir, ir)
                ud = norm(d[sel])
                cos = np.minimum(np.sum(-ud * n[sel], -1), 1.0)
                sin = np.sqrt(np.maximum(1 - cos * cos, 0))
                r0 = ((1 - ratio) / (1 + ratio)) ** 2
                refl_p = r0 + (1 - r0) * (1 - cos) ** 5
                choose = (ratio * sin > 1.0) | (refl_p > rng.random(ns))
                nd = np.where(choose[:, None], reflect(ud, n[sel]),
                              refract_np(ud, n[sel], ratio))
                o[sel] = p[sel]
                d[sel] = nd
                new_alive[np.flatnonzero(sel)] = True
        alive = new_alive
    return rad


def render_oracle(prims, cam, width, height, spp, max_bounces, background, seed=0):
    """cam: dict(lookfrom, lookat, up, vfov, aspect, aperture, focus).
    Returns linear mean radiance (H, W, 3) f64."""
    rng = np.random.default_rng(seed)
    lf = np.asarray(cam["lookfrom"], float)
    la = np.asarray(cam["lookat"], float)
    up = np.asarray(cam["up"], float)
    h = np.tan(np.deg2rad(cam["vfov"]) / 2)
    vw, vh = cam["aspect"] * 2 * h, 2 * h
    w_ = norm(lf - la)
    u_ = norm(np.cross(up, w_))
    v_ = np.cross(w_, u_)
    fd = cam["focus"]
    horiz = fd * vw * u_
    vert = fd * vh * v_
    llc = lf - horiz / 2 - vert / 2 - fd * w_

    img = np.zeros((height, width, 3))
    xs, ys = np.meshgrid(np.arange(width), np.arange(height))
    ys = height - 1 - ys  # top row first
    for s in range(spp):
        su = (xs + rng.random(xs.shape)) / (width - 1)
        sv = (ys + rng.random(ys.shape)) / (height - 1)
        o = np.broadcast_to(lf, (height, width, 3)).reshape(-1, 3).copy()
        d = (llc + su[..., None] * horiz + sv[..., None] * vert - lf).reshape(-1, 3)
        # aperture 0 in all oracle scenes
        rad = trace_oracle(prims, o, d, background, max_bounces, rng)
        img += rad.reshape(height, width, 3)
    return img / spp


# --- reference scene snippets for cross-checks ----------------------------

def cornell_prims():
    """CornellBox world (scene.rs:367-464) as oracle dicts."""
    lam = lambda c: {"type": "lam", "color": c}
    white = lam((0.73, 0.73, 0.73))
    prims = [
        {"type": "rect", "axis": 0, "k": 555.0, "a0": 0.0, "a1": 555.0,
         "b0": 0.0, "b1": 555.0, "dir": -1.0, "mat": lam((0.12, 0.45, 0.15))},
        {"type": "rect", "axis": 0, "k": 0.0, "a0": 0.0, "a1": 555.0,
         "b0": 0.0, "b1": 555.0, "dir": 1.0, "mat": lam((0.65, 0.05, 0.05))},
        {"type": "rect", "axis": 1, "k": 555.0, "a0": 0.0, "a1": 555.0,
         "b0": 0.0, "b1": 555.0, "dir": -1.0, "mat": white},
        {"type": "rect", "axis": 1, "k": 0.0, "a0": 0.0, "a1": 555.0,
         "b0": 0.0, "b1": 555.0, "dir": 1.0, "mat": white},
        {"type": "rect", "axis": 1, "k": 554.0, "a0": 213.0, "a1": 343.0,
         "b0": 227.0, "b1": 332.0, "dir": -1.0,
         "mat": {"type": "light", "color": (15.0, 15.0, 15.0)}},
        {"type": "rect", "axis": 2, "k": 555.0, "a0": 0.0, "a1": 555.0,
         "b0": 0.0, "b1": 555.0, "dir": -1.0, "mat": white},
    ]
    # two boxes as 6 rects each (AABox, geometry.rs:391-446)
    for mn, mx in [((130.0, 0.0, 65.0), (295.0, 165.0, 230.0)),
                   ((265.0, 0.0, 295.0), (430.0, 330.0, 460.0))]:
        prims += [
            {"type": "rect", "axis": 2, "k": mn[2], "a0": mn[0], "a1": mx[0],
             "b0": mn[1], "b1": mx[1], "dir": -1.0, "mat": white},
            {"type": "rect", "axis": 2, "k": mx[2], "a0": mn[0], "a1": mx[0],
             "b0": mn[1], "b1": mx[1], "dir": 1.0, "mat": white},
            {"type": "rect", "axis": 1, "k": mn[1], "a0": mn[0], "a1": mx[0],
             "b0": mn[2], "b1": mx[2], "dir": -1.0, "mat": white},
            {"type": "rect", "axis": 1, "k": mx[1], "a0": mn[0], "a1": mx[0],
             "b0": mn[2], "b1": mx[2], "dir": 1.0, "mat": white},
            {"type": "rect", "axis": 0, "k": mn[0], "a0": mn[1], "a1": mx[1],
             "b0": mn[2], "b1": mx[2], "dir": -1.0, "mat": white},
            {"type": "rect", "axis": 0, "k": mx[0], "a0": mn[1], "a1": mx[1],
             "b0": mn[2], "b1": mx[2], "dir": 1.0, "mat": white},
        ]
    glass = {"type": "diel", "ir": 1.5}
    prims.append({"type": "sphere", "center": (212.5, 255.0, 147.5), "radius": 90.0, "mat": glass})
    prims.append({"type": "sphere", "center": (347.5, 420.0, 377.5), "radius": 90.0, "mat": glass})
    return prims


def cornell_camera():
    return {"lookfrom": (278.0, 278.0, -800.0), "lookat": (278.0, 278.0, 0.0),
            "up": (0.0, 1.0, 0.0), "vfov": 40.0, "aspect": 1.0,
            "aperture": 0.0, "focus": 10.0}

"""Native C++ runtime components vs their python oracles."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from rust_pathtracer_tpu import native
from rust_pathtracer_tpu.bvh import FlatBvh, build_bvh_numpy
from rust_pathtracer_tpu.scene.obj_loader import parse_obj_arrays, write_test_obj

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built"
)


def _valid_flat_bvh(flat: FlatBvh, bmin, bmax, leaf_size):
    n = bmin.shape[0]
    assert sorted(flat.prim_order.tolist()) == list(range(n))
    leaves = np.flatnonzero(flat.leaf_count > 0)
    assert int(flat.leaf_count[leaves].sum()) == n
    assert int(flat.leaf_count.max()) <= leaf_size
    for li in leaves:
        f, c = int(flat.leaf_first[li]), int(flat.leaf_count[li])
        prims = flat.prim_order[f : f + c]
        assert (flat.bbox_min[li] <= bmin[prims].min(0) + 1e-5).all()
        assert (flat.bbox_max[li] >= bmax[prims].max(0) - 1e-5).all()
    for i in range(flat.miss.shape[0]):
        assert flat.miss[i] == -1 or flat.miss[i] > i
    assert flat.miss[0] == -1


@pytest.mark.parametrize("n,leaf_size", [(1, 4), (5, 1), (100, 4), (1000, 8)])
def test_native_bvh_structure(n, leaf_size):
    rng = np.random.default_rng(n)
    centers = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    sizes = rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32)
    bmin, bmax = centers - sizes, centers + sizes
    flat = native.build_bvh(bmin, bmax, leaf_size)
    _valid_flat_bvh(flat, bmin, bmax, leaf_size)
    # same node count and leaf population as the numpy oracle
    ref = build_bvh_numpy(bmin, bmax, leaf_size)
    assert flat.bbox_min.shape == ref.bbox_min.shape
    assert np.array_equal(
        np.sort(flat.leaf_count[flat.leaf_count > 0]),
        np.sort(ref.leaf_count[ref.leaf_count > 0]),
    )


def test_native_bvh_traversal_equivalence():
    """Closest hits through the native-built BVH == brute force."""
    from rust_pathtracer_tpu.ops.bvh_traverse import closest_hit_bvh
    from rust_pathtracer_tpu.ops.intersect import closest_hit_brute
    from rust_pathtracer_tpu.scene.builder import SceneBuilder
    from rust_pathtracer_tpu.scene.types import BvhArrays

    rng = np.random.default_rng(7)
    b = SceneBuilder()
    m = b.lambertian((0.5, 0.5, 0.5))
    for _ in range(200):
        b.add_sphere(rng.uniform(-10, 10, 3), rng.uniform(0.1, 1.0), m)
    brute = b.build(use_bvh=False)

    bmin = np.stack(b._bbox_min)
    bmax = np.stack(b._bbox_max)
    flat = native.build_bvh(bmin, bmax, 4)
    order = flat.prim_order
    prims = brute.prims._replace(
        kind=brute.prims.kind[order],
        mat=brute.prims.mat[order],
        aux=brute.prims.aux[order],
        data=brute.prims.data[order],
    )
    bvh = BvhArrays(
        bbox_min=jnp.asarray(flat.bbox_min),
        bbox_max=jnp.asarray(flat.bbox_max),
        miss=jnp.asarray(flat.miss),
        leaf_first=jnp.asarray(flat.leaf_first),
        leaf_count=jnp.asarray(flat.leaf_count),
    )
    R = 256
    o = jnp.asarray(rng.uniform(-12, 12, (R, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(R, 3)), jnp.float32)
    h1, t1, _ = closest_hit_brute(brute.prims, o, d, 1e-3, 1e30)
    h2, t2, _ = closest_hit_bvh(bvh, prims, o, d, 1e-3, 1e30, leaf_size=4)
    assert np.array_equal(np.asarray(h1), np.asarray(h2))
    hm = np.asarray(h1)
    assert np.allclose(np.asarray(t1)[hm], np.asarray(t2)[hm], rtol=1e-5, atol=1e-4)


def test_native_obj_matches_python(tmp_path):
    p = os.path.join(tmp_path, "m.obj")
    write_test_obj(p)
    nv, nn, nh, nm, nmats = parse_obj_arrays(p, prefer_native=True)
    pv, pn, ph, pm, pmats = parse_obj_arrays(p, prefer_native=False)
    assert np.allclose(nv, pv)
    assert np.array_equal(nh, ph)
    assert np.allclose(nn, pn)
    assert len(nmats) == len(pmats)
    for a, b in zip(nmats, pmats):
        assert np.allclose(a["kd"], b["kd"])
        assert a["illum"] == b["illum"]
        assert np.isclose(a["ns"], b["ns"]) and np.isclose(a["ni"], b["ni"])
    # python path may order materials by mtllib order vs first-use; map
    # via kd to compare per-tri assignment
    def kd_of(mats, idx):
        return [tuple(np.round(mats[i]["kd"], 5)) if i >= 0 else None for i in idx]

    assert kd_of(nmats, nm) == kd_of(pmats, pm)


def test_native_obj_normals_and_neg_indices(tmp_path):
    p = os.path.join(tmp_path, "n.obj")
    with open(p, "w") as f:
        f.write(
            "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
            "vn 0 0.70710678 0.70710678\n"
            "f -4//1 -3//1 -2//1\nf 1 3 4\n"
        )
    v, n, h, m, mats = parse_obj_arrays(p, prefer_native=True)
    assert v.shape == (2, 3, 3)
    # reference normal rule (obj_model.rs:87-96): the raw vn array is
    # indexed by the first vertex's POSITION index whenever the file
    # has any vn line — so BOTH faces get vn[0] here (their first
    # vertices are position 0), including the face written without //vn
    assert bool(h[0]) and bool(h[1])
    assert np.allclose(n[0], [0, 0.70710678, 0.70710678])
    assert np.allclose(n[1], [0, 0.70710678, 0.70710678])
    assert m.tolist() == [-1, -1] and mats == []


def test_native_build_ignores_compiler_environment(monkeypatch):
    """The library is built with the system g++ and fixed flags: a CXX
    exported for another gcc builds against that gcc's libstdc++, and
    the library crashed beside the interpreter's own."""
    import subprocess

    from rust_pathtracer_tpu import native

    seen = {}

    def fake_run(cmd, **kw):
        seen["cmd"], seen["env"] = cmd, kw["env"]
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setenv("CXX", "/opt/other/bin/g++")
    monkeypatch.setenv("CXXFLAGS", "-static-libstdc++")
    monkeypatch.setattr(native.subprocess, "run", fake_run)
    native._try_build()
    assert seen["cmd"][:2] == ["make", "-s"]
    assert "CXX=g++" in seen["cmd"]
    assert any(a.startswith("CXXFLAGS=") and "-fPIC" in a
               for a in seen["cmd"])
    assert "CXX" not in seen["env"] and "CXXFLAGS" not in seen["env"]


def test_native_build_rebuilds_when_flags_change(tmp_path):
    """make rebuilds the library when the compiler or its flags change
    (they are stamped into .build_flags), and only then."""
    import shutil
    import subprocess

    from rust_pathtracer_tpu import native

    src = tmp_path / "csrc"
    shutil.copytree(native._CSRC, src,
                    ignore=shutil.ignore_patterns("*.so", ".build_flags"))

    def build(flags):
        subprocess.run(["make", "-s", "CXX=g++", f"CXXFLAGS={flags}"],
                       cwd=src, check=True, capture_output=True, timeout=180)
        return (src / "libptnative.so").stat().st_mtime_ns

    base = "-O3 -fPIC -std=c++17 -Wall"
    t0 = build(base)
    assert build(base) == t0
    t1 = build("-O1 -fPIC -std=c++17 -Wall")
    assert t1 != t0
    assert (src / ".build_flags").read_text().strip() == (
        "g++ -O1 -fPIC -std=c++17 -Wall")

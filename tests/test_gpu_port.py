"""The GPU port's plumbing, checked on the CPU: kernel routing, the
compile cache location, the Pillow-free PNG codec, the device records,
and the measurement scripts' refusal to run without a GPU."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from rust_pathtracer_tpu.ops import fused_bounce as fb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# knobs that once selected an interpreter or a kernel by environment
OLD_ENV_KNOBS = ("RPT_FB_INTERPRET", "RPT_PROJ_INTERPRET",
                 "RPT_DISABLE_PALLAS", "RPT_FUSED_BOUNCE", "RPT_FBD_EINSUM",
                 "RPT_FBD_BWD", "RPT_FB_BLOCK_ROWS", "RPT_V1_BLOCK_ROWS")


# ---- routing ---------------------------------------------------------------

@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_route_does_not_depend_on_backend(monkeypatch, backend):
    """The fused bounce and the static sweep are plain jnp: the CPU
    takes the route the card takes, for a fused scene and for one that
    is not (image texture: composed bounce, static sweep)."""
    from rust_pathtracer_tpu.integrator import _fused_cols_eligible
    from rust_pathtracer_tpu.ops import intersect

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    cornell, textured = _cornell(), _textured()
    assert fb.fused_bounce_ok(cornell) and fb.fused_bounce_diff_ok(cornell)
    assert _fused_cols_eligible(cornell, False, None, 20, 1 << 20)
    assert not fb.fused_bounce_ok(textured)
    called = []
    monkeypatch.setattr(intersect, "closest_hit_static",
                        lambda *a, **k: called.append(1))
    o = jax.numpy.zeros((4, 3))
    intersect.closest_hit(textured, o, o + 1.0, 1e-3, 1e30)
    assert called


@pytest.mark.parametrize("knob", OLD_ENV_KNOBS)
def test_no_env_var_selects_interpret(monkeypatch, knob):
    """No environment variable turns the interpreter (or any kernel)
    on: a CornellBox trace is bitwise the same with the knob set."""
    from rust_pathtracer_tpu import sampling
    from rust_pathtracer_tpu.integrator import trace

    scene = _cornell()
    n = 64
    o = jax.numpy.tile(jax.numpy.asarray([[278.0, 278.0, -800.0]]), (n, 1))
    ang = jax.numpy.linspace(-0.2, 0.2, n)
    d = jax.numpy.stack([ang, 0.1 * ang, jax.numpy.ones_like(ang)], 1)
    keys = sampling.lane_keys(jax.random.PRNGKey(0),
                              jax.numpy.arange(n, dtype=jax.numpy.uint32))
    r0, s0 = trace(scene, o, d, keys, (0.0, 0.0, 0.0), max_bounces=4)
    monkeypatch.setenv(knob, "1")
    jax.clear_caches()
    r1, s1 = trace(scene, o, d, keys, (0.0, 0.0, 0.0), max_bounces=4)
    np.testing.assert_array_equal(np.asarray(r0), np.asarray(r1))
    assert float(s0.segments) == float(s1.segments)


def _cornell():
    from rust_pathtracer_tpu.models import get_scene

    return get_scene("CornellBox").build()


def _textured():
    from rust_pathtracer_tpu.scene.builder import SceneBuilder

    b = SceneBuilder()
    img = np.linspace(0, 1, 4 * 4 * 3).reshape(4, 4, 3).astype(np.float32)
    b.add_sphere((0, 0, -3), 1.0, b.lambertian(b.image_texture(img)))
    return b.build(use_bvh=False)


def test_fused_route_eligibility(monkeypatch):
    """Static table-free scenes take the column scan; image textures,
    BVH-sized scenes, residuals past the remat threshold and the
    rederive estimator keep the generic loops."""
    from rust_pathtracer_tpu.integrator import _fused_cols_eligible
    from rust_pathtracer_tpu.models import get_scene

    cornell = _cornell()
    field = get_scene("SphereField").build()
    textured = _textured()

    assert _fused_cols_eligible(cornell, False, None, 20, 1 << 20)
    assert _fused_cols_eligible(cornell, True, None, 20, 1 << 20)
    # residuals past the "auto" remat threshold: generic remat loop
    assert not _fused_cols_eligible(cornell, True, None, 20, 1 << 22)
    assert not _fused_cols_eligible(field, False, None, 20, 1 << 20)
    assert not _fused_cols_eligible(textured, False, None, 20, 1 << 20)
    monkeypatch.setenv("RPT_DIFF_T", "rederive")
    assert not _fused_cols_eligible(cornell, True, None, 20, 1 << 20)
    assert _fused_cols_eligible(cornell, False, None, 20, 1 << 20)


def test_no_old_accelerator_code_left():
    """No Pallas import for the old accelerator, no backend branch for
    it and no interpreter-selecting environment knob remains in the
    package or the entry scripts."""
    import re

    old = "t" + "pu"  # spelled apart so this file does not match itself
    pat = re.compile(rf"pallas\.{old}|pl{old}|== \"{old}\"|"
                     + "|".join(OLD_ENV_KNOBS))
    offenders = []
    files = [os.path.join(ROOT, f) for f in os.listdir(ROOT)
             if f.endswith(".py")]
    for dirpath, _dirs, names in os.walk(
            os.path.join(ROOT, "rust_pathtracer_tpu")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if pat.search(line):
                    offenders.append(f"{path}:{i}: {line.strip()}")
    assert not offenders, offenders


def test_every_pallas_call_names_triton():
    """A hand-written kernel in the package names its GPU backend
    (there is none today: the fused bounce is left to XLA)."""
    import re

    for dirpath, _dirs, names in os.walk(
            os.path.join(ROOT, "rust_pathtracer_tpu")):
        for n in names:
            if not n.endswith(".py"):
                continue
            src = open(os.path.join(dirpath, n)).read()
            for m in re.finditer(r"pallas_call\(", src):
                assert 'backend="triton"' in src[m.start():m.start() + 1500]


# ---- compile cache -----------------------------------------------------------

def test_compcache_honours_env_dir(monkeypatch, tmp_path):
    from rust_pathtracer_tpu.utils import compcache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compcache.cache_dir() == (str(tmp_path), False)
    updates = {}
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    assert compcache.enable() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in updates  # JAX reads the env


def test_compcache_default_is_fixed_checkout_path(monkeypatch):
    from rust_pathtracer_tpu.utils import compcache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path, must_set = compcache.cache_dir()
    assert must_set and path == os.path.join(ROOT, ".jax_cache")
    updates = {}
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    monkeypatch.setattr(os, "makedirs", lambda *a, **k: None)
    assert compcache.enable() == path
    assert updates["jax_compilation_cache_dir"] == path


def test_compcache_skips_cpu(monkeypatch):
    from rust_pathtracer_tpu.utils import compcache

    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    assert compcache.enable() == ""
    assert not updates


# ---- PNG codec without Pillow -------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (48, 64)])
def test_png_round_trip_without_pillow(monkeypatch, tmp_path, shape):
    from rust_pathtracer_tpu.utils import image

    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL -> error
    rgb = np.random.default_rng(sum(shape)).integers(
        0, 256, shape + (3,), dtype=np.uint8)
    path = str(tmp_path / "sub" / "x.png")
    image.write_png(path, rgb)
    back = image.read_png(path)
    assert back.dtype == np.uint8 and back.shape == shape + (3,)
    np.testing.assert_array_equal(back, rgb)


@pytest.mark.parametrize("name", ["CornellBox", "LightTest", "ModelTest",
                                  "perlin_parity"])
def test_read_png_decodes_filtered_files(name):
    """read_png undoes every PNG scanline filter: the committed preview
    images (written by other encoders) decode as Pillow decodes them."""
    from PIL import Image

    from rust_pathtracer_tpu.utils.image import read_png

    path = os.path.join(ROOT, "preview", f"{name}.png")
    want = np.asarray(Image.open(path).convert("RGB"), np.uint8)
    np.testing.assert_array_equal(read_png(path), want)


def test_png_is_readable_by_pillow(tmp_path):
    from PIL import Image

    from rust_pathtracer_tpu.utils.image import write_png

    rgb = np.arange(6 * 4 * 3, dtype=np.uint8).reshape(6, 4, 3)
    write_png(str(tmp_path / "a.png"), rgb)
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "a.png").convert("RGB")), rgb)


def test_write_gif_without_pillow_says_so(monkeypatch, tmp_path):
    from rust_pathtracer_tpu.utils import image

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="Pillow"):
        image.write_gif(str(tmp_path / "a.gif"),
                        [np.zeros((2, 2, 3), np.uint8)], fps=10.0)


# ---- device records and no-GPU refusals -------------------------------------

def test_require_gpu_refuses_cpu():
    from rust_pathtracer_tpu.utils.device import NoGpuError, require_gpu

    with pytest.raises(NoGpuError, match="no GPU"):
        require_gpu()


def test_card_power_without_nvidia_smi(monkeypatch):
    from rust_pathtracer_tpu.utils import device

    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(device.subprocess, "run", missing)
    assert "unavailable" in device.card_power()


def _run_script(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("args", [["chip_smoke.py"],
                                  ["chip_smoke.py", "--four"],
                                  ["bench.py"],
                                  ["bench_scenes.py", "--quick"]])
def test_measurement_scripts_refuse_without_gpu(args):
    r = _run_script(args, ROOT)
    assert r.returncode != 0, r.stdout
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_script(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert r.stdout.strip() == ""

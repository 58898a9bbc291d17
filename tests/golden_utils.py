"""Golden-image regression anchors.

Small fixed-key renders of every judging scene on the deterministic CPU
path, committed as .npy artifacts (tests/goldens/).  Counter-based RNG
makes the renderer bitwise reproducible for a fixed configuration, so
any energy / orientation / texture-phase drift (renderer.rs:21-33
contract) turns into an exact-array test failure.  Regenerate
consciously with tools/gen_goldens.py after an intended change.

Regeneration log (why an anchor moved — keep this current so future
rounds can distinguish intended ulp drift from real regressions):

* round 4 (commit 68b4814): LightTest + TwoSphereCheckers regenerated
  when RPT_RNG_XS=1 became the default.  Hoisting the per-bounce
  threefry UNIFORM draws out of the scan changes which fusion context
  computes the downstream trig transforms, and XLA's vectorization of
  a transcendental can differ by 1 ulp across fusion contexts; over
  10+ bounces that flips an occasional discrete decision (hit/miss,
  absorb) in a handful of lanes.  Max golden drift observed: 1.5e-6.
  NOT an energy/orientation change — the independent f64 oracle tests
  (tests/test_oracle_parity.py) pinned the estimator through the
  change (DESIGN.md §13 "RNG-hoist trap").
* CornellBox, LightTest and TwoSphereCheckers regenerated when the
  fused whole bounce (ops/fused_bounce.bounce_body, left to XLA)
  became the route for small table-free scenes on every backend,
  the CPU included.  Its floats differ from the composed path's by
  ulps (other fusions); an occasional flipped discrete decision
  reroutes a path.  Drift against the old anchors: max |d| 0.028 /
  5.4e-4 / 0.056, mean |d| 3.2e-6 / 2.1e-6 / 3.4e-5, image means
  0.157195 -> 0.157192, 0.101124 -> 0.101124, 0.403512 -> 0.403534.
  The f64 oracle tests pinned the estimator through the change.

The anchors come from the default (legacy) RNG stream; the opt-in
packed scheme (RPT_RNG_SCHEME=packed) draws a different stream and
does not match them.
"""

from __future__ import annotations

import os
import tempfile

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")

# name -> (scene kwargs, width, height, spp, max_bounces)
GOLDEN_CONFIGS = {
    "TwoSphereCheckers": ({}, 64, 36, 16, 8),
    "LightTest": ({}, 64, 36, 16, 12),
    "CornellBox": ({}, 64, 64, 16, 12),
    "TriangleTest": ({}, 64, 64, 16, 12),
    "SphereField": ({}, 64, 36, 8, 8),
    "ModelTest": ({"obj_path": None}, 64, 64, 8, 8),
}


def render_golden(name: str):
    """Render one golden config; returns (H, W, 3) f32 numpy."""
    import jax
    import numpy as np

    from rust_pathtracer_tpu.models import get_scene
    from rust_pathtracer_tpu.render import RenderSettings, render_radiance

    kw, w, h, spp, nb = GOLDEN_CONFIGS[name]
    kw = dict(kw)
    if "obj_path" in kw:
        from rust_pathtracer_tpu.scene.obj_loader import write_benchmark_obj

        path = os.path.join(tempfile.mkdtemp(), "golden_model.obj")
        write_benchmark_obj(path)
        kw["obj_path"] = path
    sd = get_scene(name, **kw)
    scene = sd.build()
    cam = sd.camera_at(0.0)
    settings = RenderSettings(
        w, h, spp, nb, sd.output.image.background, spp_chunk=spp
    )
    img, _ = render_radiance(scene, cam, settings, jax.random.PRNGKey(1234))
    return np.asarray(img)


def golden_path(name: str) -> str:
    return os.path.join(GOLDEN_DIR, f"{name}.npy")

import os

import jax
import numpy as np
import pytest

from rust_pathtracer_tpu.models import SCENES, get_scene
from rust_pathtracer_tpu.render import RenderSettings, render_radiance
from rust_pathtracer_tpu.scene.obj_loader import write_test_obj
from rust_pathtracer_tpu.utils.image import quantize_u8, to_rgb8


@pytest.fixture(scope="module")
def obj_path(tmp_path_factory):
    p = os.path.join(tmp_path_factory.mktemp("obj"), "model.obj")
    write_test_obj(p)
    return p


def _tiny(bg):
    return RenderSettings(
        width=32, height=32, samples_per_pixel=4, max_bounces=6, background=bg
    )


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_smoke(name, obj_path):
    kwargs = {"obj_path": obj_path} if name == "ModelTest" else {}
    sd = get_scene(name, **kwargs)
    scene = sd.build()
    img, stats = render_radiance(
        scene, sd.camera_at(0.0), _tiny(sd.output.image.background), jax.random.PRNGKey(0)
    )
    img = np.asarray(img)
    assert img.shape == (32, 32, 3)
    assert np.isfinite(img).all()
    assert img.min() >= 0.0
    assert img.mean() > 0.01  # not black
    assert float(stats.segments) > 0


def test_scene_settings_match_reference():
    # scene.rs settings table (SURVEY §6)
    expect = {
        "SphereField": (854, 480, 250, 20, (1.0, 1.0, 1.0)),
        "TwoSphereCheckers": (854, 480, 250, 20, (1.0, 1.0, 1.0)),
        "LightTest": (854, 480, 2000, 50, (0.0, 0.0, 0.0)),
        "CornellBox": (400, 400, 1000, 20, (0.0, 0.0, 0.0)),
        "TriangleTest": (400, 400, 1000, 20, (0.0, 0.0, 0.0)),
        "ModelTest": (800, 800, 250, 20, (1.0, 1.0, 1.0)),
    }
    for name, (w, h, spp, mb, bg) in expect.items():
        s = get_scene(name).output.image
        assert (s.width, s.height, s.samples_per_pixel, s.max_bounces) == (w, h, spp, mb)
        assert s.background == bg


def test_sphere_field_animation_settings():
    out = get_scene("SphereField").output
    assert out.is_animation
    assert out.num_frames == 300  # 30 fps * 10 s (scene.rs:56-57)


def test_determinism_bitwise():
    sd = get_scene("CornellBox")
    scene = sd.build()
    s = _tiny((0.0, 0.0, 0.0))
    a, _ = render_radiance(scene, sd.camera_at(0.0), s, jax.random.PRNGKey(9))
    b, _ = render_radiance(scene, sd.camera_at(0.0), s, jax.random.PRNGKey(9))
    assert np.array_equal(np.asarray(a), np.asarray(b))


def test_spp_chunking_invariance():
    # same image regardless of how spp is chunked (counter-based RNG)
    sd = get_scene("TwoSphereCheckers")
    scene = sd.build()
    base = dict(width=16, height=16, samples_per_pixel=8, max_bounces=4,
                background=(1.0, 1.0, 1.0))
    a, _ = render_radiance(
        scene, sd.camera_at(0.0), RenderSettings(**base, spp_chunk=8), jax.random.PRNGKey(1)
    )
    b, _ = render_radiance(
        scene, sd.camera_at(0.0), RenderSettings(**base, spp_chunk=3), jax.random.PRNGKey(1)
    )
    assert np.allclose(np.asarray(a), np.asarray(b), atol=2e-6)


def test_quantization_saturating_cast():
    # vec3.rs:279-287 via Rust saturating cast: >1 -> 255, <0 -> 0, NaN -> 0
    vals = np.array([[[-0.5, 0.0, 0.5], [1.0, 20.0, np.nan]]])
    q = quantize_u8(vals)
    assert q.tolist() == [[[0, 0, 127], [255, 255, 0]]]


def test_to_rgb8_gamma():
    lin = np.full((1, 1, 3), 0.25)
    assert (to_rgb8(lin) == int(0.5 * 255.999)).all()  # sqrt(0.25)=0.5


def test_cascade_matches_chunked():
    """The cascade renderer (compaction between bounce ranges) traces
    the identical per-lane paths: segment count exact, image equal up
    to f32 accumulation order (render.py _render_chunk_cascaded)."""
    import dataclasses

    import jax
    import numpy as np

    from rust_pathtracer_tpu.models import get_scene
    from rust_pathtracer_tpu.render import RenderSettings, render_radiance

    sd = get_scene("CornellBox")
    scene = sd.build()
    cam = sd.camera_at(0.0)
    s = RenderSettings(48, 48, 8, 12, sd.output.image.background, spp_chunk=4)
    img, st = render_radiance(scene, cam, s, jax.random.PRNGKey(3))
    s2 = dataclasses.replace(s, cascade=True)
    img2, st2 = render_radiance(scene, cam, s2, jax.random.PRNGKey(3))
    assert float(st.segments) == float(st2.segments)
    np.testing.assert_allclose(
        np.asarray(img), np.asarray(img2), atol=2e-6, rtol=1e-5
    )


def test_cascade_static_schedule():
    """Static-width cascade (no host sync; RenderSettings.
    cascade_schedule) must equal the chunked renderer exactly, with a
    zero overflow counter; an over-tight schedule must raise
    CascadeOverflowError instead of silently biasing."""
    import dataclasses
    import os

    import pytest

    from rust_pathtracer_tpu.render import CascadeOverflowError

    sd = get_scene("SphereField")
    scene = sd.build()
    assert scene.bvh is not None
    cam = sd.camera_at(0.0)
    s = RenderSettings(32, 18, 4, 10, (1.0, 1.0, 1.0), spp_chunk=4)
    img0, st0 = render_radiance(scene, cam, s, jax.random.PRNGKey(0))
    s_static = dataclasses.replace(
        s, cascade=True, cascade_schedule="3:2,6:4"
    )
    img1, st1 = render_radiance(scene, cam, s_static,
                                jax.random.PRNGKey(0))
    assert float(st1.segments) == float(st0.segments)
    assert float(st1.occupancy[-1]) == 0.0
    np.testing.assert_allclose(np.asarray(img1), np.asarray(img0),
                               rtol=1e-6, atol=1e-6)
    s_tight = dataclasses.replace(s, cascade=True,
                                  cascade_schedule="1:16")
    with pytest.raises(CascadeOverflowError, match="dropped"):
        render_radiance(scene, cam, s_tight, jax.random.PRNGKey(0))


def test_cascade_rational_shrink():
    """Rational shrinks ("1:8/7" keeps 7/8 of the lanes) slice at
    fractional widths that integer divisors cannot reach (ModelTest's
    59%-alive bounce 1).  Still estimator-exact: image equals the
    plain chunked renderer, overflow stays zero, and the parser
    rejects malformed or non-increasing rationals.  SphereField
    searches through its BVH."""
    import dataclasses

    import pytest

    from rust_pathtracer_tpu.render import parse_cascade_schedule

    from fractions import Fraction

    assert parse_cascade_schedule("1:8/7,6:4") == [
        (1, Fraction(8, 7)), (6, Fraction(4))
    ]
    with pytest.raises(ValueError):
        parse_cascade_schedule("1:7/8")  # shrink < 1
    with pytest.raises(ValueError):
        parse_cascade_schedule("1:3/0")
    with pytest.raises(ValueError):
        parse_cascade_schedule("1:8/7,2:9/8")  # shrinks must increase

    sd = get_scene("SphereField")
    scene = sd.build()
    cam = sd.camera_at(0.0)
    s = RenderSettings(32, 18, 4, 10, (1.0, 1.0, 1.0), spp_chunk=4)
    img0, st0 = render_radiance(scene, cam, s, jax.random.PRNGKey(0))
    # lanes = 2304; width at 8/7 = 2016 (87.5%, safe over ~68%
    # alive after bounce 0), at 6:4 = 576 (25%, same slot as the
    # test above)
    s1 = dataclasses.replace(s, cascade=True,
                             cascade_schedule="1:8/7,6:4")
    img1, st1 = render_radiance(scene, cam, s1, jax.random.PRNGKey(0))
    assert float(st1.segments) == float(st0.segments)
    assert float(st1.occupancy[-1]) == 0.0
    np.testing.assert_allclose(np.asarray(img1), np.asarray(img0),
                               rtol=1e-6, atol=1e-6)


def test_cascade_static_multi_chunk():
    """Static cascade across MULTIPLE spp chunks (the judging frames
    run hundreds): per-chunk banking + unscramble must accumulate
    identically to the chunked path, overflow stays zero."""
    import dataclasses

    sd = get_scene("CornellBox")
    scene = sd.build()
    cam = sd.camera_at(0.0)
    s = RenderSettings(24, 24, 8, 12, (0.0, 0.0, 0.0), spp_chunk=4)
    img0, st0 = render_radiance(scene, cam, s, jax.random.PRNGKey(3))
    # CornellBox occupancy: 31% alive at bounce 8 -> R/2 has 1.6x margin
    s1 = dataclasses.replace(s, cascade=True, cascade_schedule="8:2")
    img1, st1 = render_radiance(scene, cam, s1, jax.random.PRNGKey(3))
    assert float(st1.segments) == float(st0.segments)
    assert float(st1.occupancy[-1]) == 0.0
    np.testing.assert_allclose(np.asarray(img1), np.asarray(img0),
                               rtol=1e-6, atol=1e-6)


def test_cascade_auto_schedule():
    """cascade_schedule="auto": a cheap strided-pixel probe derives the
    static schedule, then EVERY chunk runs the one-jit cascade — image
    equal to the chunked renderer, zero overflow, same segments."""
    import dataclasses

    from rust_pathtracer_tpu.render import _derive_cascade_schedule

    sd = get_scene("CornellBox")
    scene = sd.build()
    cam = sd.camera_at(0.0)
    s = RenderSettings(24, 24, 12, 12, (0.0, 0.0, 0.0), spp_chunk=4)
    img0, st0 = render_radiance(scene, cam, s, jax.random.PRNGKey(5))
    s1 = dataclasses.replace(s, cascade_schedule="auto")
    img1, st1 = render_radiance(scene, cam, s1, jax.random.PRNGKey(5))
    assert float(st1.segments) == float(st0.segments)
    assert float(st1.occupancy[-1]) == 0.0
    np.testing.assert_allclose(np.asarray(img1), np.asarray(img0),
                               rtol=1e-6, atol=1e-6)

    # derivation sanity on a synthetic collapse curve: 1M lanes,
    # 66/41/29/15/4.3/2.0/1.1/...% alive (the SphereField shape).
    # New emit rules (matching the measured-best hand schedules): first
    # boundary once width <= 60% of the pool, then every >=1.4x drop —
    # this curve cuts at bounce 2 like the hand-tuned "2:2,3:3,..."
    from rust_pathtracer_tpu.render import AUTO_MARGIN

    occ = np.array([1.0, 0.66, 0.41, 0.287, 0.154, 0.043, 0.02,
                    0.0107, 0.0065] + [0.003] * 11) * (1 << 20)
    sched = _derive_cascade_schedule(occ, 1 << 20, 20)
    assert sched is not None and sched.startswith("2:")
    # widths hug AUTO_MARGIN x the live count (128-aligned rationals),
    # resolve statically, and every slice holds the margin
    from rust_pathtracer_tpu.render import _cascade_static_schedule

    stages = _cascade_static_schedule(20, 1 << 20, sched)
    assert stages, sched
    for b, w in stages:
        assert w % 128 == 0
        assert AUTO_MARGIN * occ[b] <= w < AUTO_MARGIN * occ[b] + 128


def test_derive_schedule_deterministic():
    """derive_cascade_schedule is a pure function of (scene, camera,
    settings, key): checkpointed renders re-derive on resume and must
    land on the IDENTICAL schedule for bitwise resume."""
    from rust_pathtracer_tpu.render import derive_cascade_schedule

    sd = get_scene("CornellBox")
    scene = sd.build()
    cam = sd.camera_at(0.0)
    s = RenderSettings(32, 32, 16, 12, (0.0, 0.0, 0.0), spp_chunk=4)
    a = derive_cascade_schedule(scene, cam, s, jax.random.PRNGKey(9))
    b = derive_cascade_schedule(scene, cam, s, jax.random.PRNGKey(9))
    assert a == b
    # a different key probes different jitter -> may differ, but must
    # still parse (or be None)
    c = derive_cascade_schedule(scene, cam, s, jax.random.PRNGKey(10))
    if c is not None:
        from rust_pathtracer_tpu.render import parse_cascade_schedule

        parse_cascade_schedule(c)


def test_cascade_auto_overflow_widens(monkeypatch):
    """When the probe-derived widths are too tight (forced via a tiny
    AUTO_MARGIN) the renderer OWNS the guard: it warns, re-derives at
    doubled margin, and ultimately falls back to the plain path — the
    returned image is never biased."""
    import dataclasses
    import warnings

    from rust_pathtracer_tpu import render as render_mod

    sd = get_scene("CornellBox")
    scene = sd.build()
    cam = sd.camera_at(0.0)
    s = RenderSettings(24, 24, 8, 12, (0.0, 0.0, 0.0), spp_chunk=4)
    img0, st0 = render_radiance(scene, cam, s, jax.random.PRNGKey(7))
    monkeypatch.setattr(render_mod, "AUTO_MARGIN", 0.3)
    s1 = dataclasses.replace(s, cascade_schedule="auto")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        img1, st1 = render_radiance(scene, cam, s1, jax.random.PRNGKey(7))
    assert any("dropped" in str(w.message) or "overflow" in str(w.message)
               for w in caught), [str(w.message) for w in caught]
    assert float(st1.segments) == float(st0.segments)
    np.testing.assert_allclose(np.asarray(img1), np.asarray(img0),
                               rtol=1e-6, atol=1e-6)


def test_cascade_passset_key_matches_octant_key():
    """A width-preserving "1:1" pseudo-boundary only re-sorts the
    wavefront (live lanes first); per-lane radiance is layout-
    independent, so the cascade image equals the plain chunked
    renderer with or without it (SphereField through its BVH)."""
    import dataclasses

    sd = get_scene("SphereField")
    scene = sd.build()
    cam = sd.camera_at(0.0)
    s = RenderSettings(32, 18, 4, 10, (1.0, 1.0, 1.0), spp_chunk=4,
                       cascade=True, cascade_schedule="1:1,3:2,6:4")
    imgs = {}
    for sched in ("1:1,3:2,6:4", "3:2,6:4"):
        img, st = render_radiance(
            scene, cam, dataclasses.replace(s, cascade_schedule=sched),
            jax.random.PRNGKey(0),
        )
        assert float(st.occupancy[-1]) == 0.0
        imgs[sched] = np.asarray(img)
    np.testing.assert_allclose(imgs["1:1,3:2,6:4"], imgs["3:2,6:4"],
                               rtol=1e-6, atol=1e-6)

    # and both equal the plain chunked renderer
    s0 = dataclasses.replace(s, cascade=False, cascade_schedule=None)
    img0, _ = render_radiance(scene, cam, s0, jax.random.PRNGKey(0))
    np.testing.assert_allclose(imgs["1:1,3:2,6:4"], np.asarray(img0),
                               rtol=1e-6, atol=1e-6)


def test_derive_schedule_multi_envelope():
    """derive_cascade_schedule_multi derives from the per-bounce MAX of
    the probed pose occupancies: its widths can never undercut any
    single probed pose's widths (the orbit-robust animation contract,
    cli.py sticky_auto)."""
    from rust_pathtracer_tpu.render import (
        derive_cascade_schedule,
        derive_cascade_schedule_multi,
        parse_cascade_schedule,
    )

    sd = get_scene("SphereField")
    scene = sd.build()
    cams = [sd.camera_at(t) for t in (0.0, 0.25, 0.5, 0.75)]
    s = RenderSettings(48, 27, 8, 12, (1.0, 1.0, 1.0), spp_chunk=4)
    key = jax.random.PRNGKey(3)
    multi = derive_cascade_schedule_multi(scene, cams, s, key)
    # single-pose == multi with one pose (exact refactor equivalence)
    assert derive_cascade_schedule(scene, cams[0], s, key) == \
        derive_cascade_schedule_multi(scene, [cams[0]], s, key)
    if multi is None:
        return
    n_lanes = 48 * 27 * 4
    env = {b: n_lanes / sh for b, sh in parse_cascade_schedule(multi)}
    for cam in cams:
        single = derive_cascade_schedule(scene, cam, s, key)
        if single is None:
            continue
        for b, sh in parse_cascade_schedule(single):
            w = n_lanes / sh
            cover = [we for be, we in env.items() if be <= b]
            if cover:
                assert min(cover) >= w, (multi, single, b)

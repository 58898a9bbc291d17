"""Regeneration wavefront vs the chunked renderer.

Same per-path RNG => same estimator; images agree to fp-reassociation
noise (CornellBox reproduces bitwise on CPU; a few paths may diverge
by 1-ulp t differences between the two compiled programs).
"""

import dataclasses

import jax
import numpy as np
import pytest

from rust_pathtracer_tpu.models import get_scene
from rust_pathtracer_tpu.render import RenderSettings, render_radiance
from rust_pathtracer_tpu.wavefront import render_radiance_regen

KEY = jax.random.PRNGKey(7)


@pytest.mark.parametrize("mode", ["stripe", "queue"])
@pytest.mark.parametrize(
    "name,bg",
    [("CornellBox", (0.0, 0.0, 0.0)), ("LightTest", (0.0, 0.0, 0.0)),
     ("TwoSphereCheckers", (1.0, 1.0, 1.0))],
)
def test_regen_matches_chunked(name, bg, mode):
    """Both work-handout modes (global queue / pixel-aligned stripes)
    compute the same estimator as the chunked renderer — every path's
    RNG keys off the same (pixel, sample) counter."""
    sd = get_scene(name)
    scene = sd.build()
    cam = sd.camera_at(0.0)
    s = RenderSettings(20, 20, 12, 10, bg)
    a, sa = render_radiance(scene, cam, s, KEY)
    b, sb = render_radiance_regen(scene, cam, s, KEY, lanes=1024, mode=mode)
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).mean() < 1e-5
    assert np.abs(a - b).max() < 5e-3
    # segment counts agree to the handful of ulp-divergent paths
    assert abs(float(sa.segments) - float(sb.segments)) <= 0.001 * float(sa.segments)


def test_regen_stripe_eligibility():
    """Stripe mode needs a pixel-aligned stripe (a divisor of spp
    covering total/lanes); "auto" silently falls back to the queue
    when the pool is smaller than the image."""
    import pytest

    from rust_pathtracer_tpu.wavefront import _stripe_len

    assert _stripe_len(512 * 512 * 256, 256, 1 << 20) == 64
    assert _stripe_len(20 * 20 * 12, 12, 1024) == 6
    # pool smaller than npix -> stripe longer than spp -> ineligible
    assert _stripe_len(64 * 64 * 4, 4, 128) is None

    sd = get_scene("CornellBox")
    scene = sd.build()
    cam = sd.camera_at(0.0)
    s = RenderSettings(64, 64, 4, 6, (0.0, 0.0, 0.0))
    with pytest.raises(ValueError, match="stripe"):
        render_radiance_regen(scene, cam, s, KEY, lanes=128, mode="stripe")
    a, _ = render_radiance(scene, cam, s, KEY)
    b, _ = render_radiance_regen(scene, cam, s, KEY, lanes=128, mode="auto")
    assert np.abs(np.asarray(a) - np.asarray(b)).max() < 5e-3


def test_regen_small_pool_multiple_refills():
    # pool much smaller than the queue: every lane refills many times
    sd = get_scene("CornellBox")
    scene = sd.build()
    cam = sd.camera_at(0.0)
    s = RenderSettings(8, 8, 32, 8, (0.0, 0.0, 0.0))
    a, _ = render_radiance(scene, cam, s, KEY)
    b, stats = render_radiance_regen(scene, cam, s, KEY, lanes=128)
    assert np.abs(np.asarray(a) - np.asarray(b)).max() < 5e-3
    # 8*8*32 = 2048 samples through 128 lanes => >= 16 refination rounds
    assert int(stats.bounces) >= 16


def test_regen_pool_larger_than_queue():
    sd = get_scene("CornellBox")
    scene = sd.build()
    cam = sd.camera_at(0.0)
    s = RenderSettings(6, 6, 2, 4, (0.0, 0.0, 0.0))
    a, _ = render_radiance(scene, cam, s, KEY)
    b, _ = render_radiance_regen(scene, cam, s, KEY, lanes=4096)
    assert np.abs(np.asarray(a) - np.asarray(b)).max() < 5e-3


def test_regen_reorder_matches_chunked():
    """Regen on a large scene searched through its BVH must keep the
    estimator identical to the chunked renderer."""
    import numpy as np
    from rust_pathtracer_tpu.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu.wavefront import render_radiance_regen
    from tests.test_integrator import _cluster_scene

    scene = _cluster_scene(600, use_bvh=True)
    assert scene.bvh is not None
    from rust_pathtracer_tpu.camera import make_camera

    cam = make_camera((0, 0, 30), (0, 0, 0), (0, 1, 0), 45.0, 1.0, 0.0, 10.0)
    s = RenderSettings(24, 24, 8, 5, (0.6, 0.7, 0.9), spp_chunk=8)
    img_c, st_c = render_radiance(scene, cam, s, jax.random.PRNGKey(4))
    img_r, st_r = render_radiance_regen(scene, cam, s, jax.random.PRNGKey(4),
                                        lanes=1024, flush_every=3)
    a, b = np.asarray(img_c), np.asarray(img_r)
    # a handful of ulp-divergent paths between the two compiled
    # programs (same tolerance as test_regen_matches_chunked)
    assert abs(float(st_c.segments) - float(st_r.segments)) <= (
        0.001 * float(st_c.segments)
    )
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=2e-3)
    assert np.isclose(a, b, rtol=1e-2, atol=1e-2).mean() > 0.97


def test_regen_russian_roulette_matches_chunked():
    """Regen honors russian_roulette_start with the SAME per-path RNG
    fold as the chunked roulette (integrator._bounce_step): identical
    estimator, fewer segments than without RR.  (The regen path
    silently IGNORED the setting before round 2's review.)"""
    sd = get_scene("CornellBox")
    scene = sd.build()
    cam = sd.camera_at(0.0)
    s = RenderSettings(20, 20, 12, 10, (0.0, 0.0, 0.0),
                       russian_roulette_start=3)
    a, sa = render_radiance(scene, cam, s, KEY)
    b, sb = render_radiance_regen(scene, cam, s, KEY, lanes=1024)
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).mean() < 1e-5
    assert np.abs(a - b).max() < 5e-3
    assert abs(float(sa.segments) - float(sb.segments)) <= 0.001 * float(sa.segments)
    # RR engaged: strictly fewer segments than the no-RR regen run
    s_norr = dataclasses.replace(s, russian_roulette_start=None)
    _, sb0 = render_radiance_regen(scene, cam, s_norr, KEY, lanes=1024)
    assert float(sb.segments) < float(sb0.segments)


def test_regen_occupancy_histogram():
    """Regen populates TraceStats.occupancy (round-3 review: it
    returned zeros, silently degrading metrics/bench consumers).
    occupancy[b] = lanes alive at bounce b, so it must (a) sum to the
    traced segments, (b) start at the full sample count, and (c) match
    the chunked renderer's histogram up to the handful of
    ulp-divergent paths."""
    sd = get_scene("CornellBox")
    scene = sd.build()
    cam = sd.camera_at(0.0)
    s = RenderSettings(20, 20, 12, 10, (0.0, 0.0, 0.0))
    _, sa = render_radiance(scene, cam, s, KEY)
    _, sb = render_radiance_regen(scene, cam, s, KEY, lanes=1024)
    occ = np.asarray(sb.occupancy)
    assert occ.sum() == float(sb.segments)
    assert occ[0] == 20 * 20 * 12  # every path traces bounce 0
    occ_chunked = np.asarray(sa.occupancy)
    assert np.abs(occ - occ_chunked).sum() <= 0.001 * occ_chunked.sum()
    # stripe mode banks through a different flush path; same histogram
    _, sc = render_radiance_regen(scene, cam, s, KEY, lanes=1024,
                                  mode="stripe")
    occ_stripe = np.asarray(sc.occupancy)
    assert occ_stripe.sum() == float(sc.segments)
    assert np.abs(occ_stripe - occ_chunked).sum() <= 0.001 * occ_chunked.sum()


def test_regen_fused_finished_lane_state_never_consumed(monkeypatch):
    """The fused bounce commits o/d/thr for lanes that scatter at the
    depth cap (cont_k true, depth_ok false), unlike the composed branch
    which leaves finished-lane state untouched.  That is correct ONLY
    while finished-lane state is never read again (flush consumes
    rad+work; respawn overwrites) — this test pins that invariant
    with max_bounces=1 EVERY scattering lane is depth-capped, so
    poisoning the fused bounce's committed o/d/thr with NaN on every
    lane must leave the image bitwise unchanged.  Any future
    flush/debug path that reads finished-lane thr (or o/d) turns the
    poison into a NaN image here."""
    import jax.numpy as jnp

    import rust_pathtracer_tpu.ops.fused_bounce as fb

    sd = get_scene("LightTest")
    scene = sd.build()
    cam = sd.camera_at(0.0)
    s = RenderSettings(16, 10, 6, 1, (0.0, 0.0, 0.0))
    assert fb.fused_bounce_ok(scene)
    img0, st0 = render_radiance_regen(scene, cam, s, KEY, lanes=256,
                                      flush_every=2)
    real_apply = fb.fused_bounce_apply

    def poisoned_apply(*args, **kwargs):
        o, d, thr, rad, cont_k = real_apply(*args, **kwargs)
        nan3 = jnp.full_like(o, jnp.nan)
        return nan3, nan3, nan3, rad, cont_k

    monkeypatch.setattr(fb, "fused_bounce_apply", poisoned_apply)
    jax.clear_caches()
    img1, st1 = render_radiance_regen(scene, cam, s, KEY, lanes=256,
                                      flush_every=2)
    jax.clear_caches()
    np.testing.assert_array_equal(np.asarray(img0), np.asarray(img1))
    assert float(st0.segments) == float(st1.segments)

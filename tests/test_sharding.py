import jax
import numpy as np
import pytest

from rust_pathtracer_tpu.models import get_scene
from rust_pathtracer_tpu.parallel import make_mesh, render_radiance_sharded
from rust_pathtracer_tpu.render import RenderSettings, render_radiance


@pytest.fixture(scope="module")
def cornell():
    sd = get_scene("CornellBox")
    return sd.build(), sd.camera_at(0.0)


SETTINGS = RenderSettings(
    width=24, height=24, samples_per_pixel=8, max_bounces=6, background=(0.0, 0.0, 0.0)
)


def test_mesh_shapes():
    m = make_mesh()
    assert m.shape["tiles"] * m.shape["samples"] == 8
    m2 = make_mesh(samples=2)
    assert m2.shape == {"tiles": 4, "samples": 2}
    with pytest.raises(ValueError):
        make_mesh(tiles=3, samples=2)


@pytest.mark.parametrize("tiles,samples", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_matches_single_device(cornell, tiles, samples):
    scene, cam = cornell
    key = jax.random.PRNGKey(11)
    ref, ref_stats = render_radiance(scene, cam, SETTINGS, key)
    mesh = make_mesh(tiles=tiles, samples=samples)
    img, stats = render_radiance_sharded(scene, cam, SETTINGS, key, mesh)
    # counter-based RNG: sharded result equals the single-device image
    # (up to f32 accumulation order across sample shards)
    assert np.allclose(np.asarray(img), np.asarray(ref), atol=2e-6)
    assert float(stats.segments) >= float(ref_stats.segments)


def test_sharded_odd_image_size(cornell):
    # width*height not divisible by n_tiles exercises pixel padding
    scene, cam = cornell
    s = RenderSettings(
        width=13, height=11, samples_per_pixel=4, max_bounces=4, background=(0.0, 0.0, 0.0)
    )
    key = jax.random.PRNGKey(3)
    ref, _ = render_radiance(scene, cam, s, key)
    img, _ = render_radiance_sharded(scene, cam, s, key, make_mesh(tiles=8))
    assert np.allclose(np.asarray(img), np.asarray(ref), atol=2e-6)


def test_sharded_odd_spp_split(cornell):
    # spp=10 over 4 sample groups: padded sample ranges must be masked
    scene, cam = cornell
    s = RenderSettings(
        width=16, height=8, samples_per_pixel=10, max_bounces=4, background=(0.0, 0.0, 0.0)
    )
    key = jax.random.PRNGKey(4)
    ref, _ = render_radiance(scene, cam, s, key)
    img, _ = render_radiance_sharded(scene, cam, s, key, make_mesh(tiles=2, samples=4))
    assert np.allclose(np.asarray(img), np.asarray(ref), atol=2e-6)


def test_sharded_cascade_matches_single(cornell):
    """Per-shard static cascade (trace_cascaded_static under
    shard_map): image equals the single-device plain render, overflow
    guard (occupancy[-1], psum'd across shards) stays zero."""
    import dataclasses

    scene, cam = cornell
    key = jax.random.PRNGKey(11)
    # CornellBox: 31% alive at bounce 8 -> R/2 slice has 1.6x margin
    s_plain = dataclasses.replace(SETTINGS, max_bounces=12)
    ref, _ = render_radiance(scene, cam, s_plain, key)
    s = dataclasses.replace(s_plain, cascade_schedule="8:2")
    from rust_pathtracer_tpu.render import _cascade_static_schedule

    # the schedule must actually engage for the per-shard lane count:
    # the plan's chunk is min(resolve_chunk(), spp_shard) with spp
    # split over the 2-wide samples axis
    spp_shard = -(-s.samples_per_pixel // 2)
    chunk = min(s.resolve_chunk(), spp_shard)
    lanes_per_shard = (24 * 24 // 4) * chunk
    assert _cascade_static_schedule(12, lanes_per_shard, "8:2")
    mesh = make_mesh(tiles=4, samples=2)
    img, stats = render_radiance_sharded(scene, cam, s, key, mesh)
    assert float(stats.occupancy[-1]) == 0.0
    assert np.allclose(np.asarray(img), np.asarray(ref), atol=2e-6)


def test_sharded_cascade_auto(cornell):
    """cascade_schedule="auto" on the mesh: chunk 0 calibrates (plain,
    worst-shard pmax occupancy), later chunks cascade per shard —
    image matches the single-device plain render, zero overflow."""
    import dataclasses

    scene, cam = cornell
    key = jax.random.PRNGKey(11)
    # spp 16 over the 2-wide samples axis with spp_chunk 4 -> each
    # group runs 2 chunks: chunk 0 calibrates, chunk 1 cascades
    s_plain = dataclasses.replace(
        SETTINGS, max_bounces=12, samples_per_pixel=16, spp_chunk=4
    )
    ref, _ = render_radiance(scene, cam, s_plain, key)
    s = dataclasses.replace(s_plain, cascade_schedule="auto")
    mesh = make_mesh(tiles=4, samples=2)
    img, stats = render_radiance_sharded(scene, cam, s, key, mesh)
    assert stats.occupancy is None or float(stats.occupancy[-1]) == 0.0
    assert np.allclose(np.asarray(img), np.asarray(ref), atol=2e-6)


def test_sharded_cascade_overflow_raises(cornell):
    """A deliberately tight explicit schedule on the mesh raises
    instead of returning a silently darkened image."""
    import dataclasses

    from rust_pathtracer_tpu.render import CascadeOverflowError

    scene, cam = cornell
    key = jax.random.PRNGKey(11)
    s = dataclasses.replace(SETTINGS, max_bounces=12,
                            cascade_schedule="1:16")
    mesh = make_mesh(tiles=4, samples=2)
    with pytest.raises(CascadeOverflowError, match="dropped"):
        render_radiance_sharded(scene, cam, s, key, mesh)


# COVERAGE NOTE: the fused-diff path (whole-scan custom VJP) under
# shard_map runs here as it runs on the card
# (test_sharded_fused_diff_step_matches_single below); four GPUs run
# it through `python chip_smoke.py --four`.


def test_psum_to_replicated_helper():
    """ops/fused_bounce._psum_to_replicated: inside shard_map it must
    collapse a shard-varying cotangent onto a replicated primal by an
    explicit psum (sum of shard partials, vma becomes replicated);
    outside shard_map it is an exact no-op."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from rust_pathtracer_tpu.ops.fused_bounce import _psum_to_replicated

    mesh = make_mesh(tiles=4, samples=2)
    primal = jnp.ones((3,))  # replicated "packed"-like input

    def body(x):
        # x: per-shard (varying) data; per-shard partial "gradient"
        partial = jnp.sum(x) * jnp.ones((3,))
        g = _psum_to_replicated(partial, primal)
        assert not jax.typeof(g).vma, jax.typeof(g)
        return g

    x = jnp.arange(8.0)
    out = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=P("tiles"), out_specs=P()
    ))(x)
    # sum over shards of (per-shard sum) = total sum
    np.testing.assert_allclose(np.asarray(out), np.full(3, x.sum()))

    # outside shard_map: no mesh axes -> no psum, value unchanged
    y = jnp.array([1.0, 2.0, 3.0])
    np.testing.assert_array_equal(
        np.asarray(_psum_to_replicated(y, primal)), np.asarray(y)
    )


def test_sharded_cascade_auto_overflow_retry(cornell, monkeypatch):
    """Sharded cascade_schedule="auto" with a margin far too tight: the
    derived widths drop live lanes, the renderer warns, re-derives
    and re-renders — from chunk 0's totals each time.  _run_chunks
    donates the accumulator it is handed, so every attempt must get
    its own copy (on a GPU a consumed buffer cannot be read again).
    The retried image equals the plain sharded render."""
    import dataclasses
    import warnings

    from rust_pathtracer_tpu import render as render_mod
    from rust_pathtracer_tpu.parallel import shard

    scene, cam = cornell
    key = jax.random.PRNGKey(5)
    mesh = make_mesh(tiles=4, samples=2)
    plain = RenderSettings(32, 32, 8, 8, (0.0, 0.0, 0.0), spp_chunk=2)
    ref, ref_stats = render_radiance_sharded(scene, cam, plain, key, mesh)

    handed = []
    real = shard._run_chunks

    def spy(plan, first, totals=None):
        if totals is not None:
            handed.append(totals[0])
        return real(plan, first, totals)

    monkeypatch.setattr(shard, "_run_chunks", spy)
    monkeypatch.setattr(render_mod, "AUTO_MARGIN", 0.3)
    auto = dataclasses.replace(plain, cascade_schedule="auto")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        img, stats = render_radiance_sharded(scene, cam, auto, key, mesh)
    assert any("dropped" in str(w.message) for w in caught), [
        str(w.message) for w in caught]
    # one accumulator per attempt, never the same buffer twice
    assert len(handed) >= 2
    assert len({id(a) for a in handed}) == len(handed)
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)
    assert float(stats.segments) == float(ref_stats.segments)


def test_sharded_fused_diff_step_matches_single(cornell):
    """The fused-diff training step (whole-scan custom VJP) under a tiles x samples shard_map: loss and gradients
    equal the single-device step's up to psum summation order."""
    import jax.flatten_util
    import jax.numpy as jnp

    from rust_pathtracer_tpu.grad import CameraParams, DiffParams, apply_params
    from rust_pathtracer_tpu.ops import fused_bounce as fb

    scene, _cam = cornell
    assert fb.fused_bounce_diff_ok(scene)
    settings = RenderSettings(8, 8, 4, 2, (1.0, 1.0, 1.0), spp_chunk=2,
                              differentiable=True)
    params = DiffParams.from_scene(scene, CameraParams.create(
        (278.0, 278.0, -800.0), (278.0, 278.0, 0.0), (0.0, 1.0, 0.0),
        40.0, 1.0, 0.0, 10.0), settings.background)
    key = jax.random.PRNGKey(0)
    mesh = make_mesh(tiles=4, samples=2)

    def loss_single(p):
        img, _ = render_radiance(apply_params(scene, p), p.camera.build(),
                                 settings, key, background=p.background)
        return jnp.mean(img)

    def loss_sharded(p):
        img, _ = render_radiance_sharded(
            apply_params(scene, p), p.camera.build(), settings, key, mesh,
            background=p.background)
        return jnp.mean(img)

    l1, g1 = jax.jit(jax.value_and_grad(loss_single))(params)
    l4, g4 = jax.jit(jax.value_and_grad(loss_sharded))(params)
    np.testing.assert_allclose(float(l4), float(l1), rtol=1e-6)
    f1, _ = jax.flatten_util.ravel_pytree(g1)
    f4, _ = jax.flatten_util.ravel_pytree(g4)
    f1, f4 = np.asarray(f1), np.asarray(f4)
    assert np.abs(f1).max() > 0
    np.testing.assert_allclose(f4, f1, rtol=1e-4,
                               atol=1e-5 * np.abs(f1).max())

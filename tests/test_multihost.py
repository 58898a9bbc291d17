"""Multi-process jax.distributed simulation (SURVEY §4d).

Two host processes x two virtual CPU devices each form a global
4-device mesh; both run the sharded renderer on the global mesh and
must agree with the single-process result.  Exercises the real
multi-host code path (jax.distributed.initialize + shard_map over a
mesh spanning processes) without accelerator hardware.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
os.environ["PYTHONPATH"] = ""
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, {repo!r})
rank = int(sys.argv[1])
import jax
jax.distributed.initialize({addr!r}, num_processes=2, process_id=rank)
import jax.numpy as jnp
from rust_pathtracer_tpu.models import get_scene
from rust_pathtracer_tpu.parallel import make_mesh, render_radiance_sharded
from rust_pathtracer_tpu.render import RenderSettings

sd = get_scene("CornellBox")
scene = sd.build()
settings = RenderSettings(16, 16, 4, 4, (0.0, 0.0, 0.0))
mesh = make_mesh(tiles=2, samples=2)  # 4 global devices, 2 per process
img, stats = render_radiance_sharded(
    scene, sd.camera_at(0.0), settings, jax.random.PRNGKey(3), mesh
)
# gather the tile-sharded image across processes and save the full
# pixels (each rank independently; they must agree bitwise)
import numpy as np
from jax.experimental import multihost_utils
full = np.asarray(multihost_utils.process_allgather(img, tiled=True))
np.save({outdir!r} + f"/img_rank{{rank}}.npy", full)
print(f"RANK{{rank}} SEGMENTS {{float(stats.segments):.1f}}", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_distributed_render(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(tmp_path, "worker.py")
    with open(worker, "w") as f:
        f.write(_WORKER.format(repo=repo, addr=f"localhost:{_free_port()}",
                               outdir=str(tmp_path)))

    env = {k: v for k, v in os.environ.items()}
    env["PYTHONPATH"] = ""
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(rank)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            text=True,
        )
        for rank in range(2)
    ]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]

    segs = []
    for out in outs:
        for line in out.splitlines():
            if "SEGMENTS" in line:
                segs.append(float(line.split()[-1]))
    assert len(segs) == 2, outs

    # single-process truth on the local 8-device mesh
    import jax

    from rust_pathtracer_tpu.models import get_scene
    from rust_pathtracer_tpu.parallel import make_mesh, render_radiance_sharded
    from rust_pathtracer_tpu.render import RenderSettings

    sd = get_scene("CornellBox")
    scene = sd.build()
    settings = RenderSettings(16, 16, 4, 4, (0.0, 0.0, 0.0))
    mesh = make_mesh(tiles=2, samples=2, devices=jax.devices()[:4])
    img, stats = render_radiance_sharded(
        scene, sd.camera_at(0.0), settings, jax.random.PRNGKey(3), mesh
    )
    expect = float(stats.segments)
    assert segs[0] == segs[1] == expect

    # the distributed IMAGE must match the single-process one pixel for
    # pixel (counter-based RNG keys off (pixel, sample) globally, so
    # sharding cannot change any lane's radiance)
    want = np.asarray(img)
    for rank in range(2):
        got = np.load(os.path.join(tmp_path, f"img_rank{rank}.npy"))
        assert got.shape == want.shape, (rank, got.shape, want.shape)
        np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-7,
                                   err_msg=f"rank {rank} image differs")
    got0 = np.load(os.path.join(tmp_path, "img_rank0.npy"))
    got1 = np.load(os.path.join(tmp_path, "img_rank1.npy"))
    np.testing.assert_array_equal(got0, got1)

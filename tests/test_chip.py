"""On-card checks: thin wrappers over chip_smoke.py's phases.

Marked ``gpu``; each skips (from a fixture, at run time) where JAX
finds no GPU.  On the card:

    python -m pytest tests/test_chip.py -m gpu -q

(`python chip_smoke.py` runs the same phases in one process and is the
quicker proof that the renderer still starts on the GPU.)
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def chip_ctx():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: JAX found "
                    f"{jax.devices()[0].platform} devices")
    sys.path.insert(0, ROOT)
    import chip_smoke

    ctx = {}
    chip_smoke.phase_device(ctx)
    return chip_smoke, ctx


@pytest.mark.gpu
@pytest.mark.parametrize("phase", ["headline", "cli", "bvh", "regen",
                                   "reference", "parity"])
def test_chip_phase(chip_ctx, phase):
    chip_smoke, ctx = chip_ctx
    if phase == "parity" and "headline" not in ctx:
        chip_smoke.phase_headline(ctx)
    getattr(chip_smoke, f"phase_{phase}")(ctx)

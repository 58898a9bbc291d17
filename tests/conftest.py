"""Test harness bootstrap.

The suite runs on a virtual 8-device CPU mesh (SURVEY.md §4:
``--xla_force_host_platform_device_count=8``) so sharding tests run
anywhere without several accelerators.  The XLA *backends* are created
lazily, so pinning the platform via jax.config here (before any jax op
runs) holds even where the environment points JAX at a GPU.  Tests
that need the card carry the ``gpu`` marker (pyproject.toml) and skip
here from a fixture (tests/test_chip.py).
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

assert jax.default_backend() == "cpu", "tests must run on the CPU mesh"
assert len(jax.devices()) == 8, "tests expect the virtual 8-device CPU mesh"

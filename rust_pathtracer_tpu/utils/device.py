"""The device a measurement runs on.

Every timing this repository prints names its device: JAX's platform,
``device_kind`` and device count, plus the card's name and power limit
as ``nvidia-smi`` reports them (a card held below its maximum power
runs slower under load).  A measurement path that finds no GPU stops:
it never falls back to the CPU.
"""

from __future__ import annotations

import subprocess


class NoGpuError(RuntimeError):
    """JAX found no GPU to measure on."""


def require_gpu() -> dict:
    """{"platform", "kind", "count"} of JAX's devices; raises
    NoGpuError unless they are GPUs."""
    import jax

    devs = jax.devices()
    rec = {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }
    if rec["platform"] != "gpu":
        raise NoGpuError(
            f"no GPU: JAX's default devices are {rec['platform']} "
            f"({rec['kind']}); this measurement runs on the card only"
        )
    return rec


def card_power() -> str:
    """``name, power.limit`` lines from nvidia-smi (one per card), or a
    note saying why they could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip()

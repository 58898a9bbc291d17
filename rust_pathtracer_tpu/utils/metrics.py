"""Metrics / observability.

The reference's observability is a progress bar and one stray println
(SURVEY §5).  The framework reports rays/sec, per-bounce occupancy and
wall-clock per stage, plus an optional jax.profiler trace.
"""

from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class RenderMetrics:
    width: int = 0
    height: int = 0
    spp: int = 0
    segments: float = 0.0
    wall_seconds: float = 0.0
    frames: int = 0
    occupancy: Optional[List[float]] = None  # alive lanes per bounce

    def add_occupancy(self, occ) -> None:
        occ = [float(x) for x in occ]
        if self.occupancy is None:
            self.occupancy = occ
        else:
            self.occupancy = [a + b for a, b in zip(self.occupancy, occ)]

    @property
    def rays_per_sec(self) -> float:
        return self.segments / self.wall_seconds if self.wall_seconds else 0.0

    @property
    def avg_path_length(self) -> float:
        lanes = self.width * self.height * self.spp * max(self.frames, 1)
        return self.segments / lanes if lanes else 0.0

    def report(self, file=sys.stderr) -> None:
        print(
            f"[metrics] {self.width}x{self.height}@{self.spp}spp x{max(self.frames,1)} "
            f"frames: {self.segments:.3g} ray segments in {self.wall_seconds:.2f}s "
            f"=> {self.rays_per_sec:.3g} rays/s, avg path length "
            f"{self.avg_path_length:.2f}",
            file=file,
        )
        if self.occupancy and self.occupancy[0] > 0:
            total = self.occupancy[0]
            frac = [x / total for x in self.occupancy if x > 0][:16]
            curve = " ".join(f"{x:.2f}" for x in frac)
            print(f"[metrics] wavefront occupancy by bounce: {curve}", file=file)


@dataclass
class StageTimer:
    """Named wall-clock stages (scene build, compile, render, io)."""

    stages: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    def report(self, file=sys.stderr) -> None:
        for name, dt in self.stages.items():
            print(f"[timing] {name}: {dt:.2f}s", file=file)


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """jax.profiler trace wrapper (enabled when log_dir given)."""
    if not log_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class ProgressBar:
    """Frame-level progress (indicatif counterpart, main.rs:42-49)."""

    def __init__(self, total: int, prefix: str = "rendering", file=sys.stderr):
        self.total = total
        self.done = 0
        self.prefix = prefix
        self.file = file
        self.t0 = time.perf_counter()

    def tick(self, n: int = 1) -> None:
        self.done += n
        elapsed = time.perf_counter() - self.t0
        rate = self.done / elapsed if elapsed > 0 else 0.0
        eta = (self.total - self.done) / rate if rate > 0 else float("inf")
        pct = 100.0 * self.done / self.total if self.total else 100.0
        print(
            f"\r{self.prefix}: {self.done}/{self.total} ({pct:.0f}%) "
            f"elapsed {elapsed:.0f}s eta {eta:.0f}s",
            end="",
            file=self.file,
            flush=True,
        )

    def finish(self) -> None:
        print(file=self.file)

"""Profiling and performance accounting.

* :func:`trace` — context manager around ``torch.profiler`` that writes a
  Chrome trace (``trace.json``) of what ran inside it.
* :class:`PerfReport` — MLUPS, effective device-memory bandwidth and
  GFLOP/s of a run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import pathlib

import torch

# Device-memory bytes per cell update of the one-step kernel: read 9 fp32
# populations and the uint8 fluid mask, write 9 fp32 populations.
# (lbm_tpu's BYTES_PER_CELL counts 76: its mask is fp32.)  A program that
# advances several steps per pass moves fewer per update: each step
# program states its own (``bytes_per_update`` in ops/fused.py), as
# lbm_tpu divides by ``steps_per_pass``.
BYTES_PER_CELL = 9 * 4 + 1 + 9 * 4
# fp32 operations per cell update of the port's step: the kick, the
# moments, the equilibrium and the relaxation (PERF.md §3).  (lbm_tpu's
# FLOPS_PER_CELL is 140, its approximate VPU op count of the fused step.)
FLOPS_PER_CELL = 104


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("prof"): sim.run()`` -> ``prof/trace.json``, with CUDA
    activity when a CUDA device is present."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))


@dataclasses.dataclass(frozen=True)
class PerfReport:
    """Derived performance figures for one run."""

    nx: int
    ny: int
    steps: int
    elapsed: float
    bytes_per_update: float = float(BYTES_PER_CELL)

    @property
    def cell_updates(self) -> int:
        return self.nx * self.ny * self.steps

    def _rate(self, quantity: float) -> float:
        # A zero-step run or a sub-timer-resolution elapsed reads as inf,
        # like diagnostics.ResultMetrics.mlups.
        if self.elapsed > 0.0:
            return quantity / self.elapsed
        return float("inf")

    @property
    def mlups(self) -> float:
        return self._rate(self.cell_updates) / 1e6

    @property
    def effective_bandwidth_gbs(self) -> float:
        """Nominal device-memory GB/s at ``bytes_per_update`` per update."""
        return self._rate(self.cell_updates * self.bytes_per_update) / 1e9

    @property
    def effective_gflops(self) -> float:
        """fp32 GFLOP/s at :data:`FLOPS_PER_CELL` per update."""
        return self._rate(self.cell_updates * FLOPS_PER_CELL) / 1e9

    def summary(self) -> str:
        return (
            f"{self.nx}x{self.ny} x {self.steps} steps in {self.elapsed:.3f}s: "
            f"{self.mlups:.0f} MLUPS, {self.effective_bandwidth_gbs:.0f} GB/s "
            f"effective, {self.effective_gflops:.0f} GFLOP/s"
        )

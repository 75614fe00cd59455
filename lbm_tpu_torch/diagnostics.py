"""Verification math on a distribution state (host side, numpy float64).

These mirror the host-side recomputation the reference performs after the
run: ``av_velocity`` (``d2q9-bgk.c:396-442``), ``calc_reynolds``
(``:747-752``) and the mass checker ``total_density`` (``:754-770``).
All operate on ``f[9, ny, nx]`` and a bool obstacle mask.
"""

from __future__ import annotations

import numpy as np

from lbm_tpu_torch.config import LBMParams


def velocity_field(
    f: np.ndarray, obstacles: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-cell (u_x, u_y, |u|, rho); u = 0 on obstacle cells.

    Computed in float64 on the host for diagnostic accuracy (the epilogue
    Reynolds print and the final_state writer are host-side in the
    reference too).
    """
    f = np.asarray(f, dtype=np.float64)
    fluid = ~np.asarray(obstacles, dtype=bool)
    rho = f.sum(axis=0)
    u_x = (f[1] + f[5] + f[8] - f[3] - f[6] - f[7]) / rho
    u_y = (f[2] + f[5] + f[6] - f[4] - f[7] - f[8]) / rho
    u_x = np.where(fluid, u_x, 0.0)
    u_y = np.where(fluid, u_y, 0.0)
    speed = np.sqrt(u_x * u_x + u_y * u_y)
    return u_x, u_y, speed, rho


def av_velocity(f: np.ndarray, obstacles: np.ndarray, free_cells_inv: float) -> float:
    """Masked mean of |u| over fluid cells (``d2q9-bgk.c:396-442``)."""
    _, _, speed, _ = velocity_field(f, obstacles)
    fluid = ~np.asarray(obstacles, dtype=bool)
    return float(speed[fluid].sum() * free_cells_inv)


def calc_reynolds(
    params: LBMParams, f: np.ndarray, obstacles: np.ndarray, free_cells_inv: float
) -> float:
    """Re = av_vel · reynolds_dim / nu with nu = (2/omega-1)/6."""
    return (
        av_velocity(f, obstacles, free_cells_inv)
        * params.reynolds_dim
        / params.viscosity
    )


def total_density(f: np.ndarray) -> float:
    """Total mass — conserved exactly by streaming/bounce-back and to
    rounding by BGK collision."""
    return float(np.asarray(f, dtype=np.float64).sum())


class ResultMetrics:
    """Derived-metric mixin for ``RunResult`` (which carries ``params``,
    ``f``/``fields``, ``obstacles``, ``free_cells_inv``, ``elapsed`` and
    ``steps_timed``)."""

    @property
    def reynolds(self) -> float:
        if self.f is not None:
            # readback="device" leaves f a tensor, possibly on the card.
            f = self.f if isinstance(self.f, np.ndarray) else self.f.cpu().numpy()
            return calc_reynolds(self.params, f, self.obstacles, self.free_cells_inv)
        # fields mode: accumulate the masked mean of |u| in fp64 on host.
        speed = np.asarray(self.fields[2], dtype=np.float64)
        fluid = ~np.asarray(self.obstacles, dtype=bool)
        av = speed[fluid].sum() * self.free_cells_inv
        return av * self.params.reynolds_dim / self.params.viscosity

    @property
    def mlups(self) -> float:
        """Million lattice-cell updates per second of the timed steps."""
        steps = (
            self.steps_timed if self.steps_timed is not None
            else self.params.max_iters
        )
        cells = self.params.nx * self.params.ny * steps
        return cells / self.elapsed / 1e6 if self.elapsed > 0 else float("inf")

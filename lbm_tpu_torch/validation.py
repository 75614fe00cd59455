"""The float64 engine: the validation-grade reference in torch.

The port of ``lbm_tpu.validation``: an implementation of the physics that
shares no code with the step programs (accelerate, pull-stream,
collide/bounce-back, masked mean |u|; ``d2q9-bgk.c:128-132``), used to
make golden files (``lbm_tpu_torch.tools.gen_goldens``) and to hold the
fp32 paths against at high precision.  Its operations are
``lbm_tpu.validation.run64``'s, in numpy's order, one torch op for each
numpy op, so that on the CPU f is the same bits; rho is summed left to
right, as numpy sums the outer axis.  Only av differs in the last bits:
numpy sums the fluid speeds pairwise, torch in its own order.  Nothing
waits for the device before the end of the run.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.runtime import select_device

_EX = (0, 1, 0, -1, 0, 1, -1, -1, 1)
_EY = (0, 0, 1, 0, -1, 1, 1, -1, -1)
_OPP = (0, 3, 4, 1, 2, 7, 8, 5, 6)
_W = (4 / 9,) + (1 / 9,) * 4 + (1 / 36,) * 4


def _device(device) -> torch.device:
    """``device`` itself where it is a ``torch.device``, else
    :func:`select_device`'s choice for it (None: ``LBM_DEVICE``)."""
    return device if isinstance(device, torch.device) else select_device(device)


def init_cells64(params: LBMParams, device=None) -> torch.Tensor:
    """The uniform initial state, ``[9, ny, nx]`` float64 on ``device``."""
    f = torch.empty((9, params.ny, params.nx), dtype=torch.float64,
                    device=_device(device))
    f[0] = params.density * 4.0 / 9.0
    f[1:5] = params.density / 9.0
    f[5:9] = params.density / 36.0
    return f


def run64(
    params: LBMParams,
    obstacles: np.ndarray,
    max_iters: int | None = None,
    f0: np.ndarray | torch.Tensor | None = None,
    device=None,
) -> tuple[torch.Tensor, np.ndarray]:
    """Run ``max_iters`` steps in float64 on ``device``; returns ``(f,
    av_vels)``: f a ``[9, ny, nx]`` tensor on the device, av_vels a host
    array read back once at the end."""
    dev = _device(device)
    if max_iters is None:
        max_iters = params.max_iters
    fluid = ~torch.as_tensor(np.asarray(obstacles, bool), device=dev)
    free_cells = int(fluid.sum())
    if f0 is None:
        f = init_cells64(params, dev)
    else:
        f = torch.as_tensor(f0, dtype=torch.float64, device=dev).clone()
    av = torch.empty(max_iters, dtype=torch.float64, device=dev)
    ex = torch.tensor(_EX, dtype=torch.float64, device=dev)[:, None, None]
    ey = torch.tensor(_EY, dtype=torch.float64, device=dev)[:, None, None]
    w = torch.tensor(_W, dtype=torch.float64, device=dev)[:, None, None]
    opp = torch.tensor(_OPP, device=dev)

    w1 = params.density * params.accel / 9.0
    w2 = params.density * params.accel / 36.0
    row = params.ny - 2
    omega = params.omega

    for t in range(max_iters):
        # body force on row ny-2 (positivity-guarded, fluid cells only)
        r = f[:, row, :]
        ok = fluid[row] & (r[3] - w1 > 0.0) & (r[6] - w2 > 0.0) & (r[7] - w2 > 0.0)
        kick = ok.to(torch.float64)
        r[1] += kick * w1
        r[5] += kick * w2
        r[8] += kick * w2
        r[3] -= kick * w1
        r[6] -= kick * w2
        r[7] -= kick * w2

        # pull-stream with periodic wrap
        tmp = torch.stack([torch.roll(f[k], (_EY[k], _EX[k]), dims=(0, 1))
                           for k in range(9)])

        # macroscopic moments + equilibrium
        rho = functools.reduce(torch.add, tmp.unbind(0))
        ux = (tmp[1] + tmp[5] + tmp[8] - tmp[3] - tmp[6] - tmp[7]) / rho
        uy = (tmp[2] + tmp[5] + tmp[6] - tmp[4] - tmp[7] - tmp[8]) / rho
        usq = ux * ux + uy * uy
        eu = ex * ux + ey * uy
        feq = w * rho * (1.0 + 3.0 * eu + 4.5 * eu * eu - 1.5 * usq)

        relaxed = tmp + omega * (feq - tmp)
        f = torch.where(fluid, relaxed, tmp[opp])
        # Masked by a where, not by indexing, which would wait for the
        # device every step.
        av[t] = torch.where(fluid, torch.sqrt(usq), 0.0).sum() / free_cells
    return f, av.cpu().numpy()

"""Plain-torch D2Q9-BGK ops — the readable, any-device reference path.

Each op mirrors one stage of the reference pipeline (accelerate_flow,
propagate, rebound, collision, av_velocity — ``d2q9-bgk.c:128-132``) as a
whole-grid tensor transform, and mirrors ``lbm_tpu.ops.reference`` op for
op.  It is the port's golden model: the CUDA kernel in
:mod:`lbm_tpu_torch.ops.fused` is held against it, and it is what that
module runs on CPU tensors.

Array convention: ``f[9, ny, nx]`` float32, speeds-major, contiguous.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.ops.lattice import CX, CY, NSPEEDS, OPPOSITE, WEIGHTS, kick_scale


def uniform_weights(params: LBMParams) -> np.ndarray:
    """The 9 per-speed values of the uniform initial state: w0·rho, w1·rho,
    w2·rho per speed class (``d2q9-bgk.c:529-550``), exact fp32."""
    rho = np.float32(params.density)
    return np.array(
        [rho * np.float32(4.0) / np.float32(9.0)]
        + [rho / np.float32(9.0)] * 4
        + [rho / np.float32(36.0)] * 4,
        dtype=np.float32,
    )


def init_cells(params: LBMParams, device: torch.device | str = "cpu") -> torch.Tensor:
    """Uniform initial distributions on ``device``, contiguous
    (``d2q9-bgk.c:529-550``)."""
    w = torch.as_tensor(uniform_weights(params), device=device)
    return w[:, None, None].expand(NSPEEDS, params.ny, params.nx).contiguous()


def accel_weights(params: LBMParams) -> tuple[np.float32, np.float32]:
    """Body-force weights w1 = rho·a/9, w2 = rho·a/36 (``kernels.cl:14-15``)."""
    da = np.float32(params.density) * np.float32(params.accel)
    return da / np.float32(9.0), da / np.float32(36.0)


def accelerate_flow(
    f: torch.Tensor,
    obstacles_row: torch.Tensor,
    w1: np.float32,
    w2: np.float32,
    row: int,
) -> torch.Tensor:
    """Apply the body force to grid row ``row`` (= ny-2 in the reference);
    returns a new tensor.

    The force fires per cell only when the cell is fluid AND all three
    west-side populations stay strictly positive after the kick
    (``kernels.cl:29-33``).
    """
    r = f[:, row, :]  # [9, nx]
    ok = (
        (~obstacles_row)
        & (r[3] - float(w1) > 0.0)
        & (r[6] - float(w2) > 0.0)
        & (r[7] - float(w2) > 0.0)
    )
    scale = torch.tensor(
        [0.0 if s is None else float(s)
         for s in (kick_scale(k, w1, w2) for k in range(NSPEEDS))],
        dtype=f.dtype,
        device=f.device,
    )
    out = f.clone()
    out[:, row, :] = r + ok.to(f.dtype) * scale[:, None]
    return out


def stream(f: torch.Tensor) -> torch.Tensor:
    """Pull-streaming with fully periodic wrap in both axes:
    ``tmp[k][y, x] = f[k][y - cy_k, x - cx_k]`` (``kernels.cl:91-113``)."""
    return torch.stack(
        [
            torch.roll(f[k], (int(CY[k]), int(CX[k])), dims=(0, 1))
            for k in range(NSPEEDS)
        ]
    )


def kick_scales(params: LBMParams, f: torch.Tensor) -> torch.Tensor:
    """The per-speed body-force kick (0 for the unkicked speeds) as a
    ``[9, 1, ..., 1]`` tensor that broadcasts against ``f``."""
    w1, w2 = accel_weights(params)
    return torch.tensor(
        [0.0 if s is None else float(s)
         for s in (kick_scale(k, w1, w2) for k in range(NSPEEDS))],
        dtype=f.dtype, device=f.device,
    ).view(NSPEEDS, *([1] * (f.dim() - 1)))


def accelerate_masked(
    f: torch.Tensor, fluid: torch.Tensor, row_is_kick: torch.Tensor, params: LBMParams
) -> torch.Tensor:
    """The body force on every row of a tile where ``row_is_kick``
    (``[rows, 1]`` bool: the row's global index is ny-2), gated per cell
    as :func:`accelerate_flow`; returns a new tensor (``lbm_tpu``'s
    ``_accelerate_masked``, ``parallel/sharded.py:117``).  A cell that does
    not kick adds 0, so its values keep their bits."""
    w1, w2 = accel_weights(params)
    ok = (
        row_is_kick
        & fluid
        & (f[3] - float(w1) > 0.0)
        & (f[6] - float(w2) > 0.0)
        & (f[7] - float(w2) > 0.0)
    )
    return f + ok.to(f.dtype) * kick_scales(params, f)


def stream_with_ghosts(ext: torch.Tensor) -> torch.Tensor:
    """Pull-streaming of the owned cells of a tile padded by one halo cell
    on every side: ``tmp[k][y, x] = ext[k][y + 1 - cy_k, x + 1 - cx_k]``,
    ``[9, nyl + 2, nxl + 2] -> [9, nyl, nxl]`` (``lbm_tpu``'s
    ``_stream_with_ghosts``, ``parallel/sharded.py:99``, with the x halo
    of its 2-D path)."""
    nyl, nxl = ext.shape[1] - 2, ext.shape[2] - 2
    return torch.stack(
        [
            ext[k, 1 - int(CY[k]):1 - int(CY[k]) + nyl, 1 - int(CX[k]):1 - int(CX[k]) + nxl]
            for k in range(NSPEEDS)
        ]
    )


def macroscopic(
    tmp: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Density, 1/density and *momentum* (un-normalized velocity):
    ``(rho, rho_inv, mx, my)`` (``kernels.cl:119-143``).  rho is summed
    left to right, ``((t0 + t1) + t2) + ...``, as the CUDA kernels do:
    ``torch.sum`` over dim 0 associates differently in its vector tails,
    so its bits would depend on the tensor's shape."""
    rho = functools.reduce(torch.add, tmp.unbind(0))
    rho_inv = 1.0 / rho
    mx = tmp[1] + tmp[5] + tmp[8] - tmp[3] - tmp[6] - tmp[7]
    my = tmp[2] + tmp[5] + tmp[6] - tmp[4] - tmp[7] - tmp[8]
    return rho, rho_inv, mx, my


def equilibrium(
    rho: torch.Tensor, rho_inv: torch.Tensor, mx: torch.Tensor, my: torch.Tensor
) -> torch.Tensor:
    """BGK equilibrium in momentum form (``kernels.cl:146-185``), computed
    per opposite-speed pair: ``feq_{k,opp(k)} = shared ± beta``."""
    msq = mx * mx + my * my
    half_icsq_rinv = 1.5 * rho_inv
    feq: list[torch.Tensor] = [None] * NSPEEDS
    feq[0] = float(WEIGHTS[0]) * (rho - half_icsq_rinv * msq)
    for a, b, eu in ((1, 3, mx), (2, 4, my), (5, 7, mx + my), (6, 8, my - mx)):
        w = float(WEIGHTS[a])
        equ = 3.0 * eu
        shared = w * (rho + half_icsq_rinv * (equ * eu - msq))
        beta = w * equ
        feq[a] = shared + beta
        feq[b] = shared - beta
    return torch.stack(feq)


def collide(
    tmp: torch.Tensor, fluid: torch.Tensor, omega: np.float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused BGK collision + bounce-back + |u| accumulation.

    Fluid cells relax toward equilibrium; obstacle cells reflect the
    streamed-in populations into their opposite slots (``kernels.cl:187-197``).
    Returns ``(f_new, tot_u)`` with ``tot_u`` the *sum* of |u| over fluid
    cells (the caller multiplies by 1/free_cells).
    """
    rho, rho_inv, mx, my = macroscopic(tmp)
    feq = equilibrium(rho, rho_inv, mx, my)
    relaxed = tmp + float(omega) * (feq - tmp)
    bounced = tmp[torch.as_tensor(OPPOSITE, dtype=torch.long, device=tmp.device)]
    f_new = torch.where(fluid[None], relaxed, bounced)
    speed = torch.sqrt(mx * mx + my * my) * rho_inv
    tot_u = torch.sum(torch.where(fluid, speed, torch.zeros_like(speed)))
    return f_new, tot_u


def make_masked_step_fn(
    params: LBMParams, free_cells_inv: np.float32
) -> Callable[[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]:
    """Build ``step(f, fluid) -> (f_next, av_vel)`` with the fluid mask as
    an argument (bool ``[ny, nx]``, True = fluid).

    Order per step (reference ``main`` loop, ``d2q9-bgk.c:221-238``):
    accelerate_flow on the read buffer, then the fused
    propagate/rebound/collision/av_velocity pass.
    """
    omega = np.float32(params.omega)
    w1, w2 = accel_weights(params)
    row = params.ny - 2
    fcinv = float(np.float32(free_cells_inv))

    def step(f: torch.Tensor, fluid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        f = accelerate_flow(f, ~fluid[row], w1, w2, row)
        tmp = stream(f)
        f_new, tot_u = collide(tmp, fluid, omega)
        return f_new, tot_u * fcinv

    return step

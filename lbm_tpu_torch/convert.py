"""Carry a state across between ``lbm_tpu`` and the port.

Both packages hold f as ``[9, ny, nx]`` float32, speeds-major, which is
also the ``f`` array of ``lbm_tpu``'s v1 checkpoint (``.npz``); the mask is
a bool ``[ny, nx]`` with True = obstacle.  Takes numpy arrays (for a JAX
array, ``np.asarray`` it first), so this module needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def state_from_jax(
    f_np, obstacles: np.ndarray, device: torch.device | str
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(f, fluid)`` on ``device``: f as contiguous float32 ``[9, ny, nx]``
    and the fluid mask as uint8 ``[ny, nx]`` (1 = fluid), the layouts
    :class:`lbm_tpu_torch.ops.fused.FusedStep` takes."""
    f_np = np.array(f_np, dtype=np.float32)  # a writable copy
    obstacles = np.asarray(obstacles, dtype=bool)
    if f_np.ndim != 3 or f_np.shape[0] != 9 or f_np.shape[1:] != obstacles.shape:
        raise ValueError(
            f"f must be [9, ny, nx] matching obstacles {obstacles.shape}, "
            f"got {f_np.shape}"
        )
    f = torch.from_numpy(f_np).to(device)
    fluid = torch.from_numpy((~obstacles).astype(np.uint8)).to(device)
    return f, fluid


def state_to_numpy(f: torch.Tensor) -> np.ndarray:
    """f on the host as float32 ``[9, ny, nx]`` (the v1 checkpoint f-format,
    and what ``lbm_tpu``'s ``Simulator.run(f0=...)`` takes)."""
    return np.ascontiguousarray(f.detach().to("cpu", torch.float32).numpy())

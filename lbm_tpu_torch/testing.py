"""Seeded inputs that exercise every branch of the step, for comparing two
implementations of it (the CPU tests and ``chip_smoke.py`` share them),
and the fields payload that exercises every float16 value of the fields
readback's reconstruction (:func:`fp16_sweep`).

The body-force gate only matters at the boundary columns and the obstacle
cells of row ny-2, so :func:`gate_case` puts obstacles in that row and
drives f3, f6 or f7 below the kick there in some columns (including the
wrap columns 0 and nx-1), so that gating on the wrong column or on
post-stream values shows up.
"""

from __future__ import annotations

import numpy as np

from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.ops.reference import accel_weights, uniform_weights


def gate_case(
    ny: int, nx: int, seed: int, accel: float = 0.005
) -> tuple[LBMParams, np.ndarray, np.ndarray]:
    """``(params, obstacles, f0)``: 5% random obstacles plus every fifth
    column of row ny-2; ``f0`` = the uniform state times
    ``1 + 0.01 N(0, 1)``, with the kick gate forced false in an eighth of
    the columns of row ny-2 (at least three)."""
    rng = np.random.default_rng(seed)
    params = LBMParams(nx, ny, 1, 10, 0.1, accel, 1.85)
    obstacles = rng.random((ny, nx)) < 0.05
    row = ny - 2
    obstacles[row, ::5] = True
    f0 = uniform_weights(params)[:, None, None] * (
        1.0 + 0.01 * rng.standard_normal((9, ny, nx))
    )
    f0 = f0.astype(np.float32)
    aw1, aw2 = accel_weights(params)
    cols = rng.permutation(nx)[: max(3, nx // 8)]
    cols[:2] = (0, nx - 1)
    f0[3, row, cols[0::3]] = np.float32(0.5) * aw1
    f0[6, row, cols[1::3]] = np.float32(0.5) * aw2
    f0[7, row, cols[2::3]] = np.float32(0.5) * aw2
    return params, obstacles, f0


def fp16_sweep(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``(raw, obstacles)``: a float16 ``[3, 256, 256]`` fields payload
    that holds each of the 65,536 float16 bit patterns once in every plane
    (zeros of both signs, subnormals, inf and NaN too), each plane shuffled
    by its own draw, and a mask of 10% obstacles."""
    rng = np.random.default_rng(seed)
    bits = np.arange(1 << 16, dtype=np.uint16)
    raw = np.stack([rng.permutation(bits) for _ in range(3)]).view(np.float16)
    return raw.reshape(3, 256, 256), rng.random((256, 256)) < 0.1


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    """Whether two float32 arrays hold the same bits, a NaN matching any
    NaN (its payload is not compared)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if a.shape != b.shape:
        return False
    nan = np.isnan(a)
    return bool(np.array_equal(nan, np.isnan(b))
                and np.array_equal(a[~nan].view(np.int32), b[~nan].view(np.int32)))

"""The fixed work of one solve, counted once here, whichever kernel does it.

A cell update is 104 fp32 operations: the kick, the moments, the
equilibrium and the relaxation of the coursework's step.  A solve reads
each input byte once and writes each output byte once: the initial state
(9 fp32 populations, 36 B a cell) and the obstacle mask (1 B a cell) in;
the 16-bit fields payload (u_x, u_y, rho - density: 6 B a cell) and one
fp32 mean speed a step out.  The least time is the larger of the
operations over the fp32 peak outside the tensor cores and the bytes over
the memory peak (``peaks.json``); neither number depends on the program's
own byte count, tiles or compile flags.
"""

from __future__ import annotations

FLOP_PER_UPDATE = 104
F_BYTES_PER_CELL = 9 * 4
MASK_BYTES_PER_CELL = 1
FIELDS_BYTES_PER_CELL = 3 * 2
AV_BYTES_PER_STEP = 4


def solve_flop(nx: int, ny: int, steps: int) -> int:
    return FLOP_PER_UPDATE * nx * ny * steps


def solve_bytes(nx: int, ny: int, steps: int) -> int:
    cells = nx * ny
    return (cells * (F_BYTES_PER_CELL + MASK_BYTES_PER_CELL + FIELDS_BYTES_PER_CELL)
            + AV_BYTES_PER_STEP * steps)


def least_time(nx: int, ny: int, steps: int, peaks: dict) -> tuple[float, str]:
    """The least seconds one card could take for a solve, and which bound
    sets it (``"compute"`` or ``"memory"``)."""
    compute = solve_flop(nx, ny, steps) / peaks["fp32_flop_per_s"]
    memory = solve_bytes(nx, ny, steps) / peaks["memory_byte_per_s"]
    return (compute, "compute") if compute >= memory else (memory, "memory")

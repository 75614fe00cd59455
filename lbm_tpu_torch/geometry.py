"""Obstacle geometry: triplet-file I/O and canonical-case generators.

Parity target: the reference loads obstacles as ``xx yy 1`` triplets with
range checks and a duplicate-guarded free-cell counter
(``d2q9-bgk.c:571-586``).  The four shipped cases are all a lid-driven
channel box:

* side walls at ``x = 0`` and ``x = nx-1`` on every row,
* full top/bottom walls at ``y = 0`` and ``y = ny-1`` (except 128x256, which
  is open in y and instead has a full-width interior wall at ``y = 127``),
* 1024x1024 additionally has an interior vertical wall at ``x = 341``.

The mask convention everywhere in this package: ``obstacles[y, x]`` is True
for a blocked cell (row-major ``[ny, nx]``, matching the reference's
``obstacles[ii*nx + jj]``).  The obstacle file is parsed natively
(``lbm_tpu_torch._native``), or by ``lbm_tpu.geometry``'s pure-Python
parser where the native one is not available (after a warning) or the
file holds a byte beyond ASCII; both take and refuse the same files.
"""

from __future__ import annotations

import pathlib
import re

import numpy as np

from lbm_tpu_torch import _native

# Strict decimal-integer tokens: optional sign, ASCII digits (what the
# reference's sscanf %ld accepts; Python's bare int() also takes '1_2').
_INT_TOKEN = re.compile(r"[+-]?[0-9]+")


def load_obstacle_file(
    path: str | pathlib.Path, nx: int, ny: int
) -> tuple[np.ndarray, int]:
    """Load an ``xx yy 1`` triplet file into a bool mask.

    Returns ``(obstacles[ny, nx] bool, free_cells)`` where ``free_cells``
    counts unique fluid cells (duplicate triplets counted once, as in the
    reference's ``if(!obstacles[...]) free_cells--`` guard).
    """
    parsed = _native.parse_obstacles(path, nx, ny)
    if parsed is not None:
        return parsed
    return parse_obstacles_python(path, nx, ny)


def parse_obstacles_python(
    path: str | pathlib.Path, nx: int, ny: int
) -> tuple[np.ndarray, int]:
    """The pure-Python parser of :func:`load_obstacle_file`."""
    mask = np.zeros((ny, nx), dtype=bool)
    with open(path) as fp:
        for lineno, line in enumerate(fp, 1):
            fields = line.split()
            if not fields:
                continue
            if len(fields) != 3:
                raise ValueError(
                    f"{path}:{lineno}: expected 3 values per line, got {len(fields)}"
                )
            if not all(_INT_TOKEN.fullmatch(v) for v in fields):
                raise ValueError(
                    f"{path}:{lineno}: expected 3 integers per line"
                )
            xx, yy, blocked = (int(v) for v in fields)
            if not 0 <= xx < nx:
                raise ValueError(f"{path}:{lineno}: obstacle x-coord out of range")
            if not 0 <= yy < ny:
                raise ValueError(f"{path}:{lineno}: obstacle y-coord out of range")
            if blocked != 1:
                raise ValueError(
                    f"{path}:{lineno}: obstacle blocked value should be 1"
                )
            mask[yy, xx] = True
    return mask, int(nx * ny - mask.sum())


def write_obstacle_file(path: str | pathlib.Path, mask: np.ndarray) -> None:
    """Write a bool mask as ``xx yy 1`` triplets (column-major sweep)."""
    ys, xs = np.nonzero(mask)
    order = np.lexsort((ys, xs))  # sweep x outer, y inner like a wall painter
    lines = [f"{x} {y} 1" for x, y in zip(xs[order], ys[order])]
    pathlib.Path(path).write_text("\n".join(lines) + "\n")


def free_cells_of(mask: np.ndarray) -> int:
    """Number of fluid (unblocked) cells."""
    return int(mask.size - mask.sum())


def channel_box(
    nx: int,
    ny: int,
    *,
    top_bottom_walls: bool = True,
    interior_row: int | None = None,
    interior_col: int | None = None,
) -> np.ndarray:
    """Generate the reference family of channel-box obstacle masks."""
    mask = np.zeros((ny, nx), dtype=bool)
    mask[:, 0] = True
    mask[:, nx - 1] = True
    if top_bottom_walls:
        mask[0, :] = True
        mask[ny - 1, :] = True
    if interior_row is not None:
        mask[interior_row, :] = True
    if interior_col is not None:
        mask[:, interior_col] = True
    return mask


def canonical_obstacles(case: str) -> np.ndarray:
    """Masks identical to the reference ``obstacles_<case>.dat`` files."""
    if case == "128x128":
        return channel_box(128, 128)
    if case == "128x256":
        # Periodic in y; full-width interior wall at y=127 instead of lids.
        return channel_box(128, 256, top_bottom_walls=False, interior_row=127)
    if case == "256x256":
        return channel_box(256, 256)
    if case == "1024x1024":
        return channel_box(1024, 1024, interior_col=341)
    raise KeyError(f"unknown canonical case {case!r}")

"""Output writers byte-compatible with the reference (and with ``lbm_tpu``).

``final_state.dat``: per cell ``"%d %d %.12E %.12E %.12E %.12E %d\n"`` =
``x y u_x u_y |u| pressure obstacle`` with u=0 and pressure=density/3 on
obstacle cells (``d2q9-bgk.c:772-856``).  Fluid-cell velocities are the
correct ones (the reference writes stale shadowed values there); the
checker reads only columns 0, 1 and 5 (x, y, pressure), so parity holds.

``av_vels.dat``: ``"%d:\t%.12E\n"`` per timestep.

Both writers take the native path (``lbm_tpu_torch._native``, built from
``_native/lbmio.c`` on first use) and run the pure-Python writers below
where it is not available, after a warning.  The two write the same bytes,
which are ``lbm_tpu.io``'s.  Their spans, ``io.final_state`` and
``io.av_vels``, count the ``bytes`` put on disk and, on the native path,
the ``values`` formatted and how many of them took the C library's
``%.12E`` (``libc``: the doubles that are not float32 values).
"""

from __future__ import annotations

import os
import pathlib

import numpy as np

from lbm_tpu_torch import _native
from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.diagnostics import velocity_field
from lbm_tpu_torch.utils import profiling

C_SQ = 1.0 / 3.0


def final_state_columns(
    params: LBMParams, f: np.ndarray, obstacles: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-cell (u_x, u_y, |u|, pressure) grids in write-out convention."""
    obstacles = np.asarray(obstacles, dtype=bool)
    u_x, u_y, speed, rho = velocity_field(f, obstacles)
    pressure = np.where(obstacles, params.density * C_SQ, rho * C_SQ)
    return u_x, u_y, speed, pressure


def write_final_state(
    path: str | pathlib.Path,
    params: LBMParams,
    f: np.ndarray | None,
    obstacles: np.ndarray,
    fields: np.ndarray | None = None,
) -> None:
    """Write ``final_state.dat`` (row-major sweep: y outer, x inner).

    Accepts either the 9-plane distribution state ``f`` (columns derived
    on host in fp64) or a precomputed ``fields = [u_x, u_y, |u|,
    pressure]`` stack (the ``readback='fields'`` path).
    """
    obstacles = np.asarray(obstacles, dtype=bool)
    with profiling.span("io.final_state") as write:
        if fields is not None:
            u_x, u_y, speed, pressure = np.asarray(fields, dtype=np.float64)
        elif f is None:
            raise ValueError(
                "write_final_state needs exactly one of f (distribution "
                "state) or fields ([u_x, u_y, |u|, pressure] stack); got "
                "neither — did the run use a readback mode that returned "
                "the other payload?"
            )
        else:
            u_x, u_y, speed, pressure = final_state_columns(params, f, obstacles)
        columns = (u_x, u_y, speed, pressure)
        written = _native.write_final_state(path, columns, obstacles)
        if written is None:
            write_final_state_python(path, columns, obstacles)
        _count(write, path, written)


def _count(write, path, written: _native.Written | None) -> None:
    """Put what a writer wrote on its span, where one records."""
    if write:
        write.set(bytes=os.path.getsize(path))
        if written is not None:
            write.set(**written._asdict())


def write_final_state_python(
    path: str | pathlib.Path, columns, obstacles: np.ndarray
) -> None:
    """The pure-Python ``final_state.dat`` writer of the four ``[ny, nx]``
    columns (u_x, u_y, |u|, pressure) and the bool mask."""
    ny, nx = obstacles.shape
    xs = np.tile(np.arange(nx), ny)
    ys = np.repeat(np.arange(ny), nx)
    obs = obstacles.ravel().astype(int)
    cols = [np.asarray(c, dtype=np.float64).ravel() for c in columns]
    with open(path, "w") as fp:
        fp.writelines(
            f"{x} {y} {a:.12E} {b:.12E} {c:.12E} {p:.12E} {o}\n"
            for x, y, a, b, c, p, o in zip(xs, ys, *cols, obs)
        )


def write_av_vels(path: str | pathlib.Path, av_vels: np.ndarray) -> None:
    """Write ``av_vels.dat``."""
    with profiling.span("io.av_vels") as write:
        written = _native.write_av_vels(path, av_vels)
        if written is None:
            write_av_vels_python(path, av_vels)
        _count(write, path, written)


def write_av_vels_python(path: str | pathlib.Path, av_vels: np.ndarray) -> None:
    """The pure-Python ``av_vels.dat`` writer."""
    av = np.asarray(av_vels, dtype=np.float64)
    with open(path, "w") as fp:
        fp.writelines(f"{i}:\t{v:.12E}\n" for i, v in enumerate(av))


def read_av_vels(path: str | pathlib.Path) -> np.ndarray:
    """Parse an ``av_vels.dat`` (ours or a reference golden); always 1-D
    (a single-step file must not collapse to a 0-d scalar)."""
    return np.loadtxt(path, usecols=[1], ndmin=1)


def read_final_state(path: str | pathlib.Path) -> np.ndarray:
    """Parse a ``final_state.dat`` into its full 7-column table; always
    2-D (a single-cell file must not collapse to a row vector)."""
    return np.loadtxt(path, ndmin=2)

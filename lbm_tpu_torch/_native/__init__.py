"""The native host I/O: ``lbmio.c``, built with the host's C compiler and
loaded with ``ctypes``.

``io.write_final_state``, ``io.write_av_vels`` and
``geometry.load_obstacle_file`` call :func:`write_final_state`,
:func:`write_av_vels` and :func:`parse_obstacles` here.  Each returns
None or False where the library is not available, and the caller then
runs its pure-Python path, whose output the native one matches byte for
byte.  The writers format each float32 value (as every value the CLI
writes is) exactly by their own arithmetic, and any other double with the
C library's ``%.12E``; they return how many of each.

The library is built from the package's own source on first use, never at
import: the compiler is ``sysconfig``'s ``CC``, else ``cc``, with
``-O2 -shared -fPIC``, into ``build/lbm_tpu_torch/liblbmio-<hash>.so``
(the hash covers the source and the flags), written under a temporary
name and renamed into place, so processes that build at once leave one
good library.  Where no compiler is found, or the build or the load
fails, a ``RuntimeWarning`` says why, once a process, and the pure-Python
paths run.
"""

from __future__ import annotations

import ctypes
import errno
import functools
import hashlib
import os
import pathlib
import shlex
import shutil
import subprocess
import sysconfig
import threading
import typing
import warnings

import numpy as np

from lbm_tpu_torch.ops._build import BUILD_DIR
from lbm_tpu_torch.utils import profiling

SOURCE = pathlib.Path(__file__).resolve().with_name("lbmio.c")
CFLAGS = ("-O2", "-shared", "-fPIC")

# lbmio.c's codes below 0 (a positive code is an errno).
PARSE_ERROR, NOT_ASCII, NO_LOCALE = -1, -2, -3

# Calls that the native library served, by function.
CALLS = {"write_final_state": 0, "write_av_vels": 0, "parse_obstacles": 0}

_P, _L = ctypes.c_void_p, ctypes.c_long
SIGNATURES = {
    "lbm_write_final_state": ([ctypes.c_char_p] + [_P] * 5 + [_L, _L, _P], ctypes.c_int),
    "lbm_write_av_vels": ([ctypes.c_char_p, _P, _L, _P], ctypes.c_int),
    "lbm_parse_obstacles": ([ctypes.c_char_p, _L, _L, _P, _P, ctypes.c_char_p, _L],
                            ctypes.c_int),
}


class Written(typing.NamedTuple):
    """What a native writer wrote: ``values`` doubles, and how many of them
    took the C library's ``%.12E`` (``libc``: the finite ones that are not
    float32 values; NaN and the infinities are fixed strings)."""

    values: int
    libc: int


class NativeBuildError(RuntimeError):
    """The native I/O library could not be built or loaded."""


def find_compiler() -> list[str] | None:
    """``sysconfig``'s ``CC`` (a command line, e.g. ``gcc -pthread``) where
    its program is on ``PATH``, else ``cc``; None where neither is."""
    cc = shlex.split(sysconfig.get_config_var("CC") or "")
    if cc and shutil.which(cc[0]):
        return cc
    return ["cc"] if shutil.which("cc") else None


def library_path() -> pathlib.Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256("\0".join(CFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"liblbmio-{h.hexdigest()[:16]}.so"


def compile_library(out: pathlib.Path) -> None:
    """Compile ``lbmio.c`` into ``out``: under a name of this process and
    thread, then renamed into place (atomic on one file system)."""
    cc = find_compiler()
    if cc is None:
        raise NativeBuildError("no C compiler found (sysconfig CC, cc)")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [*cc, *CFLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise NativeBuildError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"{' '.join(cmd)} failed (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def open_library(path: pathlib.Path) -> ctypes.CDLL:
    """Build ``path`` if it is missing, load it, declare the signatures."""
    if not path.is_file():
        compile_library(path)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise NativeBuildError(f"cannot load {path}: {e}") from e
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


@functools.cache
def library() -> ctypes.CDLL | None:
    """The loaded library, or None after warning why it is not there (the
    set-up stage ``setup.native``)."""
    try:
        with profiling.span("setup.native", always=True):
            return open_library(library_path())
    except NativeBuildError as e:
        warnings.warn(f"lbm_tpu_torch: the native I/O library is not available "
                      f"({e}); the pure-Python writers and obstacle parser run "
                      f"instead, with the same output, more slowly",
                      RuntimeWarning, stacklevel=3)
        return None


def available() -> bool:
    """Whether the native library is built and loaded (builds on first
    call)."""
    return library() is not None


def _check(code: int, path) -> None:
    """Raise for a failed call: an errno as ``open()`` raises it (the
    ``OSError`` subclass of the errno)."""
    if code > 0:
        raise OSError(code, os.strerror(code), str(path))
    if code == NO_LOCALE:
        raise OSError(errno.EINVAL, "lbmio: cannot make the C locale", str(path))


def _f64(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float64).ravel()


def write_final_state(path, columns, obstacles: np.ndarray) -> Written | None:
    """Write ``final_state.dat`` from the four ``[ny, nx]`` columns (u_x,
    u_y, |u|, pressure) and the bool mask; None if the library is not
    available (nothing written)."""
    lib = library()
    if lib is None:
        return None
    ny, nx = obstacles.shape
    cols = [_f64(c) for c in columns]
    if any(c.size != ny * nx for c in cols):
        raise ValueError(f"final_state columns must hold {ny}x{nx} values each")
    obs = np.ascontiguousarray(obstacles, dtype=np.uint8)
    libc = ctypes.c_long()
    _check(lib.lbm_write_final_state(os.fsencode(path), *(c.ctypes.data for c in cols),
                                     obs.ctypes.data, ny, nx, ctypes.addressof(libc)), path)
    CALLS["write_final_state"] += 1
    return Written(4 * ny * nx, libc.value)


def write_av_vels(path, av) -> Written | None:
    """Write ``av_vels.dat``; None if the library is not available."""
    lib = library()
    if lib is None:
        return None
    av = _f64(av)
    libc = ctypes.c_long()
    _check(lib.lbm_write_av_vels(os.fsencode(path), av.ctypes.data, av.size,
                                 ctypes.addressof(libc)), path)
    CALLS["write_av_vels"] += 1
    return Written(av.size, libc.value)


def parse_obstacles(path, nx: int, ny: int) -> tuple[np.ndarray, int] | None:
    """``(mask[ny, nx] bool, free_cells)`` of an obstacle file; None where
    the library is not available or the file holds a byte beyond ASCII
    (the pure-Python parser decides what such a file means).  A malformed
    line raises ``ValueError`` with the pure-Python parser's message."""
    lib = library()
    if lib is None:
        return None
    mask = np.zeros((ny, nx), dtype=np.uint8)
    free = ctypes.c_long()
    err = ctypes.create_string_buffer(256)
    code = lib.lbm_parse_obstacles(os.fsencode(path), nx, ny, mask.ctypes.data,
                                   ctypes.addressof(free), err, len(err))
    if code == NOT_ASCII:
        return None
    if code == PARSE_ERROR:
        raise ValueError(f"{path}:{err.value.decode()}")
    _check(code, path)
    CALLS["parse_obstacles"] += 1
    return mask.view(bool), int(free.value)


def reset_calls() -> None:
    for name in CALLS:
        CALLS[name] = 0

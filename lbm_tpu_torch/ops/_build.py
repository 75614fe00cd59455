"""Build and load the hand-written CUDA kernels.

``nvcc`` compiles ``lbm_tpu_torch/csrc/*.cu`` for ``sm_90a`` into a shared
library with a plain C interface, which is loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  The library lands in
``build/lbm_tpu_torch/`` at the repository root, named by a hash of the
sources and flags, so an edited ``.cu`` rebuilds and an unchanged one is
reused.  Nothing here runs at import time: the first call to
:func:`load_library` builds.  A missing ``nvcc`` or a failed build raises
:class:`BuildError`; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parents[1]
SOURCES = (_PKG / "csrc" / "lbm_step.cu",)
BUILD_DIR = _PKG.parent / "build" / "lbm_tpu_torch"

# No --use_fast_math: it makes division and sqrt approximate and flushes
# denormals, and the 1% bound over 80,000 steps has only ~4x margin.
# -fmad=false: with nvcc's default FMA contraction the kernel's av_vels
# drifted from an fp64 run by 1.7e-4 (64x96) and 3.1e-4 (128x128)
# relative after 1000 steps on an H100, ten times the plain torch
# version's drift; without it, 1.3e-5 and 1.5e-5, as close as the plain
# version.  The kernel is bound by memory, not by arithmetic.
# -Xptxas -v reports registers and spills into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class BuildError(RuntimeError):
    """The CUDA kernels could not be built or loaded."""


def find_nvcc() -> str | None:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    ``nvcc`` on ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    return shutil.which("nvcc")


def library_path() -> pathlib.Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblbm_step-{h.hexdigest()[:16]}.so"


def compile_library(out: pathlib.Path) -> float:
    """Run nvcc into ``out`` (atomically: a temp name, then a rename);
    the compiler's output goes to ``out`` + ``.log``.  Returns seconds."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise BuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    tic = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - tic
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    out.with_name(out.name + ".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"nvcc failed (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return seconds


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with the C
    signatures declared."""
    path = library_path()
    if not path.is_file():
        compile_library(path)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise BuildError(f"cannot load {path}: {e}") from e
    vp = ctypes.c_void_p
    lib.lbm_num_partials.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.lbm_num_partials.restype = ctypes.c_int
    lib.lbm_fused_step.argtypes = [vp, vp, vp, vp, vp, vp, vp]
    lib.lbm_fused_step.restype = ctypes.c_int
    lib.lbm_error_string.argtypes = [ctypes.c_int]
    lib.lbm_error_string.restype = ctypes.c_char_p
    return lib

"""Build and load the hand-written CUDA kernels.

``nvcc`` compiles each ``lbm_tpu_torch/csrc/*.cu`` for ``sm_90a`` into an
object, all of them at once in parallel processes, and links the objects
into one shared library with a plain C interface, which is loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  The library
lands in ``build/lbm_tpu_torch/`` at the repository root, named by a hash
of the sources, the header and the flags, so an edited ``.cu`` rebuilds
and an unchanged one is reused.  Nothing here runs at import time: the first call to
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
import tempfile
import time

from lbm_tpu_torch.utils import profiling

_PKG = pathlib.Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
SOURCES = (_CSRC / "lbm_step.cu", _CSRC / "lbm_multi.cu", _CSRC / "lbm_temporal.cu",
           _CSRC / "lbm_temporal_xt.cu", _CSRC / "lbm_shard.cu", _CSRC / "lbm_ablate.cu",
           _CSRC / "lbm_roofline.cu", _CSRC / "lbm_temporal16.cu",
           _CSRC / "lbm_multi_bands.cu", _CSRC / "lbm_ipc.cu", _CSRC / "lbm_expand.cu")
HEADERS = (_CSRC / "lbm_cell.cuh", _CSRC / "lbm_persistent.cuh")
BUILD_DIR = _PKG.parent / "build" / "lbm_tpu_torch"

# No --use_fast_math: it makes division and sqrt approximate and flushes
# denormals, and the 1% bound over 80,000 steps has only ~4x margin.
# -fmad=false: with nvcc's default FMA contraction the kernel's av_vels
# drifted from an fp64 run by 1.7e-4 (64x96) and 3.1e-4 (128x128)
# relative after 1000 steps on an H100, ten times the plain torch
# version's drift; without it, 1.3e-5 and 1.5e-5, as close as the plain
# version.  The kernel is bound by memory, not by arithmetic.
# -Xptxas -v reports registers and spills into the build log.
# `cooperative_groups::this_grid().sync()` (lbm_multi.cu,
# lbm_multi_bands.cu) needs no -rdc.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LINK_FLAGS = ("-shared",)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L, _D = ctypes.c_longlong, ctypes.c_double
# The library's C functions: (argument types, result type).  Every pointer
# and the stream are c_void_p, or ctypes would pass them as 32-bit ints.
SIGNATURES = {
    "lbm_num_partials": ([_I, _I], _I),
    "lbm_fused_step": ([_P] * 7, _I),
    "lbm_multi_num_blocks": ([_I, _I], _I),
    "lbm_multi_step": ([_P] * 5 + [_I, _I, _P, _P], _I),
    "lbm_multi_bands_smem_bytes": ([_I] * 3, _I),
    "lbm_multi_bands_threads": ([_I] * 3, _I),
    "lbm_multi_bands_width": ([_I] * 3, _I),
    "lbm_multi_bands_step": ([_P] * 6 + [_I] * 3 + [_P, _P], _I),
    "lbm_handoff_probe": ([_I] * 4 + [_P], _I),
    "lbm_temporal_smem_bytes": ([_I] * 3, _I),
    "lbm_sm_count": ([_I], _I),
    "lbm_temporal_blocks_per_sm": ([_I] * 4, _I),
    "lbm_temporal_step": ([_P] * 6 + [_I] * 4 + [_P], _I),
    "lbm_temporal16_blocks_per_sm": ([_I] * 4, _I),
    "lbm_temporal16_step": ([_P] * 6 + [_I] * 5 + [_P], _I),
    "lbm_temporal_xt_blocks_per_sm": ([_I] * 4, _I),
    "lbm_temporal_xt_step": ([_P] * 7 + [_I] * 4 + [_P], _I),
    "lbm_mega_num_blocks": ([_I] * 5, _I),
    "lbm_mega_step": ([_P] * 7 + [_I] * 6 + [_P], _I),
    "lbm_shard_num_partials": ([_I, _I], _I),
    "lbm_shard_step": ([_P] * 6 + [_I] * 5 + [_P], _I),
    "lbm_shard_temporal_step": ([_P] * 6 + [_I] * 9 + [_P], _I),
    "lbm_shard_temporal_xt_step": ([_P] * 8 + [_I] * 6 + [_P], _I),
    "lbm_ablate_noop": ([_P] * 4 + [_I] * 4 + [_P], _I),
    "lbm_ablate_stream": ([_P] * 4 + [_I] * 4 + [_P], _I),
    "lbm_ablate_collide": ([_P] * 4 + [_I] * 4 + [_P], _I),
    "lbm_roofline_add": ([_P, _P, _I, _I, _I, _F, _F, _P], _I),
    "lbm_roofline_fma": ([_P, _P, _I, _I, _I, _F, _F, _P], _I),
    "lbm_roofline_mix": ([_P, _P, _I, _I, _I, _F, _F, _P], _I),
    "lbm_ipc_malloc": ([_I, _P], _I),
    "lbm_ipc_free": ([_P], _I),
    "lbm_ipc_mem_handle": ([_P, _P], _I),
    "lbm_ipc_open_mem": ([_P, _P], _I),
    "lbm_ipc_close_mem": ([_P], _I),
    "lbm_ipc_event_create": ([_P], _I),
    "lbm_ipc_event_handle": ([_P, _P], _I),
    "lbm_ipc_event_open": ([_P, _P], _I),
    "lbm_ipc_event_destroy": ([_P], _I),
    "lbm_ipc_event_record": ([_P, _P], _I),
    "lbm_ipc_stream_wait": ([_P, _P], _I),
    "lbm_exchange_pack": ([_P, _I, _I, _P, _P], _I),
    "lbm_exchange_unpack": ([_P, _I, _I, _P, _P], _I),
    "lbm_exchange_copy": ([_P, _I, _I, _P], _I),
    "lbm_expand_fields": ([_P, _L, _P, _L, _P, _L, _D, _D, _P], _I),
    "lbm_error_string": ([_I], ctypes.c_char_p),
}


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
    h = hashlib.sha256("\0".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblbm_step-{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> tuple[int, str]:
    """Start every command at once, wait for all; (first non-zero exit
    code or 0, the commands and their output)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    rc, log = 0, []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{out}")
        rc = rc or proc.returncode
    return rc, "".join(log)


def compile_library(out: pathlib.Path) -> float:
    """Compile every source into an object (one nvcc each, in parallel),
    then link them into ``out`` (atomically: a temp name, then a rename);
    the compilers' output goes to ``out`` + ``.log``.  Returns seconds."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise BuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    tic = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as objdir:
        objs = [str(pathlib.Path(objdir) / f"{src.stem}.o") for src in SOURCES]
        rc, log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                            for src, obj in zip(SOURCES, objs)])
        if rc == 0:
            rc, link_log = _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp), *objs]])
            log += link_log
    seconds = time.perf_counter() - tic
    out.with_name(out.name + ".log").write_text(log)
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"nvcc failed (exit {rc}):\n{log}")
    os.replace(tmp, out)
    return seconds


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with the C
    signatures declared (the set-up stage ``setup.library``)."""
    with profiling.span("setup.library", always=True):
        path = library_path()
        if not path.is_file():
            compile_library(path)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise BuildError(f"cannot load {path}: {e}") from e
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        return lib

"""The port's schedule choice against lbm_tpu's, and what the chooser and
the build hand the card: tiles that fit, signatures that match the C
sources, one nvcc per source.

``lbm_tpu.ops.fused.make_fused_program`` takes one of three branches (the
multi-step, temporal or one-step program); the port must take the same
branch for the same grid and step count.  Chunks, K and tiles may differ:
the budgets are Hopper's, not the TPU's.
"""

import ctypes
import dataclasses
import os
import re
import stat

import numpy as np
import pytest
import torch

import lbm_tpu
import lbm_tpu.ops.fused as jfused
from lbm_tpu_torch.config import CANONICAL_PARAMS
from lbm_tpu_torch.geometry import canonical_obstacles, free_cells_of
from lbm_tpu_torch.ops import _build, fused, schedule
from lbm_tpu_torch.utils.profiling import PerfReport

CPU = torch.device("cpu")


def test_pick_chunk_is_lbm_tpus():
    for n in range(0, 3000):
        assert schedule.pick_chunk(n) == jfused.pick_chunk(n), n
    for n in (20000, 40000, 80000, 1009, 1001, 67591):
        assert schedule.pick_chunk(n) == jfused.pick_chunk(n), n


def _jax_branch(monkeypatch, case, max_iters):
    """The build function lbm_tpu's make_fused_program calls for this case."""
    taken = []
    for name, branch in (("build_multi_step_program", "multi"),
                         ("build_temporal_program", "temporal"),
                         ("build_temporal_xtiled_program", "temporal"),
                         ("build_fused_program", "fused"),
                         ("make_reference_program", "reference")):
        monkeypatch.setattr(jfused, name,
                            lambda *a, _b=branch, **k: taken.append(_b))
    params = dataclasses.replace(
        lbm_tpu.CANONICAL_PARAMS[case], max_iters=max_iters
    )
    obstacles = lbm_tpu.canonical_obstacles(case)
    fcinv = np.float32(1.0) / np.float32(free_cells_of(obstacles))
    jfused.make_fused_program(params, obstacles, fcinv, max_iters=max_iters,
                              device_kind="cpu")
    assert len(taken) == 1
    return taken[0]


@pytest.mark.parametrize(
    "case, max_iters, branch",
    [("128x128", 40000, "multi"), ("128x256", 40000, "multi"),
     ("256x256", 80000, "multi"), ("1024x1024", 20000, "temporal"),
     ("128x128", 1009, "fused"), ("1024x1024", 1001, "fused")],
)
def test_branch_is_lbm_tpus(case, max_iters, branch, monkeypatch):
    assert _jax_branch(monkeypatch, case, max_iters) == branch
    params = CANONICAL_PARAMS[case]
    kind, args = schedule.choose_schedule(params.ny, params.nx, max_iters)
    assert kind == branch
    prog = schedule.make_fused_program(
        dataclasses.replace(params, max_iters=max_iters), canonical_obstacles(case),
        np.float32(1e-4), CPU, max_iters=max_iters,
    )
    assert type(prog) is {"multi": fused.MultiStep, "temporal": fused.TemporalStep,
                          "fused": fused.FusedStep}[branch]
    assert max_iters % prog.chunk == 0
    assert (prog.chunk > 1) == (branch != "fused")


def test_without_a_step_count_the_one_step_kernel_runs():
    assert schedule.choose_schedule(128, 128, None) == ("fused", ())
    assert schedule.choose_schedule(1024, 1024, None) == ("fused", ())
    assert schedule.choose_schedule(128, 128, 1) == ("fused", ())


@pytest.mark.parametrize("ny, nx", [(1024, 1024), (2048, 4096), (96, 4096), (1000, 1000)])
@pytest.mark.parametrize("max_iters", [20000, 1002, 1003])
def test_temporal_tiles_fit_and_divide(ny, nx, max_iters):
    picked = schedule.choose_temporal(ny, nx, max_iters)
    if max_iters % 2:
        assert picked is None
        return
    by, bx, k = picked
    assert ny % by == 0 and nx % bx == 0 and max_iters % k == 0
    assert schedule.persistent_smem_bytes(by, bx, k) <= schedule.PERSISTENT_SMEM_BUDGET
    assert k == next(q for q in schedule.TEMPORAL_K if max_iters % q == 0)


def test_temporal_smem_formula_is_the_kernels():
    """One footprint for every window kernel: the persistent pass's two
    window buffers and two masks (``lbm::pass_smem_bytes``), mirrored from
    its C source, taken by the temporal and 16-bit kernels (through
    ``lbm::launch_pass``) and the megakernel alike; the one-tile window's
    header and formula are gone."""
    csrc = _build.SOURCES[0].parent
    assert not (csrc / "lbm_window.cuh").exists()
    for path in _build.SOURCES + _build.HEADERS:
        text = path.read_text()
        assert "window_smem_bytes" not in text and "advance_window" not in text
        assert "lbm_window.cuh" not in text
    src = (csrc / "lbm_persistent.cuh").read_text()
    body = re.search(r"int pass_smem_bytes\(.*?\{(.*?)\n\}", src, re.S).group(1)
    assert "(by + 2 * ksteps) * (bx + 2 * ksteps)" in body
    assert "2 * 9 * wcells * static_cast<int>(sizeof(float)) + 2 * wcells" in body
    assert "kRedFloats = 2 * kThreads;" in src
    assert ("232448 - kRedFloats<kPassThreads> * static_cast<int>(sizeof(float))"
            in src)
    assert "constexpr int kPassThreads = 512;" in src
    assert "const int smem = pass_smem_bytes(g.by, g.bx, g.ksteps);" in src  # launch_pass
    assert not hasattr(schedule, "SMEM_BUDGET")
    assert schedule.PERSISTENT_SMEM_BUDGET == 232_448 - 2 * 512 * 4
    assert ("lbm::pass_smem_bytes(by, bx, ksteps)"
            in (csrc / "lbm_temporal.cu").read_text())
    assert ("lbm::pass_smem_bytes(by, bx, ksteps)"
            in (csrc / "lbm_temporal_xt.cu").read_text())
    assert "lbm::launch_pass<kPassThreads>(" in (csrc / "lbm_temporal16.cu").read_text()
    assert schedule.persistent_smem_bytes(32, 64, 4) == 2 * 36 * 40 * 72 + 2 * 40 * 72
    assert schedule.persistent_smem_bytes(32, 32, 4) == 2 * 36 * 1600 + 2 * 1600


def test_multistep_budget_keeps_state_in_l2():
    assert schedule.MULTISTEP_CELL_BUDGET * schedule.BYTES_PER_CELL <= schedule.L2_BYTES
    assert 512 * 512 <= schedule.MULTISTEP_CELL_BUDGET < 1024 * 1024


def test_c_signatures_match_the_sources():
    """Each C function the wrappers call, argument for argument: a pointer
    (or the stream) is c_void_p, a float is c_float, an int is c_int."""
    src = "\n".join(p.read_text() for p in _build.SOURCES)
    for name, (argtypes, restype) in _build.SIGNATURES.items():
        m = re.search(rf"^(?:const )?\w+\*? ?{name}\((.*?)\)\s*\{{", src, re.S | re.M)
        assert m, name
        args = [a.strip() for a in m.group(1).split(",")]
        want = [ctypes.c_void_p if "*" in a
                else ctypes.c_float if a.startswith("float ") else ctypes.c_int
                for a in args]
        assert argtypes == want, name
        assert restype in (ctypes.c_int, ctypes.c_char_p)


def test_bandwidth_follows_the_program():
    slow = PerfReport(nx=1024, ny=1024, steps=20000, elapsed=1.0)
    assert slow.effective_bandwidth_gbs == pytest.approx(
        1024 * 1024 * 20000 * schedule.BYTES_PER_CELL / 1e9
    )
    per = fused.window_bytes_per_update(32, 32, 8)
    temporal = PerfReport(nx=1024, ny=1024, steps=20000, elapsed=1.0,
                          bytes_per_update=per)
    assert temporal.effective_bandwidth_gbs == pytest.approx(
        slow.effective_bandwidth_gbs * per / schedule.BYTES_PER_CELL
    )
    assert per < schedule.BYTES_PER_CELL / 4


def test_build_runs_one_nvcc_per_source_then_links(tmp_path, monkeypatch):
    """A stand-in nvcc that logs its arguments and writes its -o file."""
    log = tmp_path / "calls.log"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {log}\n'
        'while [ $# -gt 0 ]; do if [ "$1" = -o ]; then shift; : > "$1"; fi; shift; done\n'
    )
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    out = tmp_path / "build" / "lib.so"
    assert _build.compile_library(out) >= 0
    assert out.is_file() and not list(out.parent.glob("*.tmp"))
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in f" {c} "]
    assert len(compiles) == len(_build.SOURCES) == 11
    for src in _build.SOURCES:
        assert sum(str(src) in c for c in compiles) == 1
    link = [c for c in calls if c not in compiles]
    assert len(link) == 1 and "-shared" in link[0].split()
    assert all(os.path.basename(o).endswith(".o") for o in link[0].split()[3:])
    assert (out.parent / "lib.so.log").read_text().count("$ ") == 12

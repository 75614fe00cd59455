#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``lbm_tpu_torch``).

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

Phases, each printed with its seconds:

1. environment: the card (``nvidia-smi`` name and power limit), torch, nvcc;
2. build: ``nvcc`` compiles each ``lbm_tpu_torch/csrc/*.cu`` for sm_90a,
   all at once, and links them into one library;
3. every kernel against its plain torch version on the card, on seeded
   inputs that exercise the body-force gate (1 launch: max |df| <= 1e-6;
   1000 steps: max |df| <= 1e-5 and av rtol <= 1e-4):
   - the one-step kernel at every grid the main path gives it plus two
     with odd block edges, also against the plain version with rho summed
     by ``torch.sum`` (the one the kernel's errors were first recorded
     against);
   - the multi-step kernel at 64x96, 37x75 and the three small canonical
     grids, with chunk 8 and chunk 200;
   - the temporal kernel at 1024x1024 with the chosen tiling and at two
     small grids (one with K > BY), against its plain version and against
     K plain one-steps;
   then times on the card, by CUDA events and as device time from
   torch.profiler: the one-step kernel at 128x128 and 1024x1024; in
   turns (A, B, C, C, B, A), at 128x128 the bound one-step loop, the
   multi-step kernel and a CUDA graph of 200 bound one-step launches, and
   at 1024x1024 the one-step kernel and the temporal kernel at the chosen
   K and at another K; the card's copy bandwidth (2 GiB) and L2-resident
   copy rate (4 MiB);
4. the main path: the four canonical cases, full length, through the
   port's CLI (``run``) with the default kernel, checked against
   ``tests/goldens/`` at 1%, then 128x128 x 1009 and 1024x1024 x 1001 (step
   counts no chunk or K divides: the one-step branch) against the golden
   prefixes; every kernel's launch count is set to 0 before each run and
   read after it;
5. reproducibility: the temporal path (1024x1024 x 1000) and the
   multi-step path (128x128 x 1000) twice each, bitwise-equal av_vels and
   f.

Any failure raises (non-zero exit, no result line).  On success the line
before the last is the kernels' JSON record and the last line is
``{"ok": true, "device": {...}}``.  Needs no JAX and no network; takes
about a minute and a half on an H100, the build included.
"""

from __future__ import annotations

import contextlib
import io
import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
GOLDENS = ROOT / "tests" / "goldens"
WORK = ROOT / "build" / "chip_smoke"

# Grids with partial blocks in x and y; the canonical grids are added to
# them in phase 3, so the kernel is checked at every shape the main path
# gives it.
ODD_SHAPES = ((64, 96), (37, 75))  # (ny, nx)
TIMED_SHAPES = ((128, 128), (1024, 1024))  # (ny, nx)
CASES = ("128x128", "128x256", "256x256", "1024x1024")
SMALL_CASES = CASES[:3]
FINAL_STATE_GOLDENS = ("128x128", "128x256")
# Step counts that no chunk or K divides: the chooser's one-step branch.
ONE_STEP_RUNS = (("128x128", 1009), ("1024x1024", 1001))
MULTI_CHUNKS = (8, 200)
# (ny, nx, by, bx, K) besides the chosen 1024x1024 tiling: 64x96 holds row
# ny-2 in the bottom tile row's wrapped south halo and the top row's
# interior; 12x20 has K > BY, so ny-2 also lies in other tiles' north halos.
TEMPORAL_SMALL = ((64, 96, 16, 32, 4), (12, 20, 4, 4, 6))
TOL_F_1, TOL_F_N, TOL_AV_N, N_STEPS = 1e-6, 1e-5, 1e-4, 1000
GRAPH_STEPS = 200  # one-step launches captured in the CUDA graph
# Temporal tilings (by, bx) swept at 1024x1024 for each K of the chooser:
# the measurement behind ops/schedule.py's TEMPORAL_TILES order.
SWEEP_TILES = ((32, 32), (16, 32), (32, 64), (16, 64), (16, 16), (8, 32))

# The card's published rates (NVIDIA's H100 SXM datasheet, at
# 700 W): device memory and fp32 outside the tensor cores.  A cell update
# does 104 fp32 operations (lbm_tpu's pinned count, tests/test_perf_model.py)
# and must move 73 B once per pass (9 fp32 + the mask byte in, 9 fp32 out).
MEM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_UPDATE = 104


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


@contextlib.contextmanager
def phase(name: str):
    tic = time.perf_counter()
    yield
    print(f"[phase] {name}: {time.perf_counter() - tic:.3f} s", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    require(bool(out), "nvidia-smi printed no card")
    return out.splitlines()[0]


def phase_env(torch) -> str:
    from lbm_tpu_torch.ops import _build

    card = card_line()
    print(card)
    nvcc = _build.find_nvcc()
    require(nvcc is not None, "nvcc not found")
    nvcc_version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[-1]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__} "
          f"(CUDA {torch.version.cuda}), nvcc: {nvcc_version}, "
          f"devices: {torch.cuda.device_count()}")
    return card


def phase_build() -> None:
    from lbm_tpu_torch.ops import _build

    path = _build.library_path()
    tic = time.perf_counter()
    _build.load_library()
    print(f"built {path.relative_to(ROOT)} in {time.perf_counter() - tic:.3f} s")
    log = path.with_name(path.name + ".log")
    if log.is_file():
        for line in log.read_text().splitlines():
            if ("registers" in line or "spill" in line or "error" in line
                    or "Compiling entry" in line):
                print(f"  {line.strip()}")


def _setup(ny, nx, seed, dev, torch):
    """Seeded gate-case inputs on the card: (params, obstacles, fcinv, f0)."""
    import numpy as np

    from lbm_tpu_torch.geometry import free_cells_of
    from lbm_tpu_torch.testing import gate_case

    params, obstacles, f0_np = gate_case(ny, nx, seed)
    fcinv = np.float32(1.0) / np.float32(free_cells_of(obstacles))
    return params, obstacles, fcinv, torch.from_numpy(f0_np).to(dev)


def _run_kernel(prog, f0, launches, torch):
    """``launches`` kernel launches from ``f0``, bound as the main path
    binds them: (f, av[launches * chunk])."""
    bufs = (f0.clone(), torch.empty_like(f0))
    av = torch.empty(launches * prog.chunk, dtype=torch.float32, device=f0.device)
    launch = prog.bind(bufs[0], bufs[1], av)
    for i in range(launches):
        launch(i)
    return bufs[prog.final_index(launches)], av


def _run_checked(step, f0, steps, torch):
    """As :func:`_run_kernel` for the one-step kernel, but each launch
    through ``step(...)``, which checks its tensors on every call: the cost
    that binding removes."""
    a, b = f0.clone(), torch.empty_like(f0)
    av = torch.empty(steps, dtype=torch.float32, device=f0.device)
    for t in range(steps):
        step(a, b, av, t)
        a, b = b, a
    return a, av


def _run_plain(prog, f0, launches, torch):
    """The plain version of ``launches`` launches of ``prog``."""
    f, avs = f0, []
    for _ in range(launches):
        f, a = prog.plain_launch(f)
        avs.append(a)
    return f, torch.cat(avs)


def _run_plain_steps(prog, f0, steps, torch):
    """``steps`` plain one-steps (``prog.plain``)."""
    f, avs = f0, []
    for _ in range(steps):
        f, a = prog.plain(f)
        avs.append(a)
    return f, torch.stack(avs)


@contextlib.contextmanager
def _torch_sum_plain(torch):
    """The plain step with rho summed by ``torch.sum`` over the 9 planes.
    The plain step sums left to right, as the kernels do; the one-step
    kernel's errors were first recorded against this older form, so its
    errors against it show that the kernel's results did not change."""
    from lbm_tpu_torch.ops import reference

    orig = reference.macroscopic

    def macroscopic(tmp):
        rho = torch.sum(tmp, dim=0)
        mx = tmp[1] + tmp[5] + tmp[8] - tmp[3] - tmp[6] - tmp[7]
        my = tmp[2] + tmp[5] + tmp[6] - tmp[4] - tmp[7] - tmp[8]
        return rho, 1.0 / rho, mx, my

    reference.macroscopic = macroscopic
    try:
        yield
    finally:
        reference.macroscopic = orig


def _errs(k, kav, p, pav):
    """(max |df|, max relative av difference)."""
    return ((k - p).abs().max().item(),
            ((kav - pav).abs() / pav.abs()).max().item())


def _check(label, err1, errn, avn, k):
    require(err1 <= TOL_F_1, f"{label}: 1-launch max|df| {err1} > {TOL_F_1}")
    require(errn <= TOL_F_N, f"{label}: {N_STEPS}-step max|df| {errn} > {TOL_F_N}")
    require(avn <= TOL_AV_N, f"{label}: {N_STEPS}-step av rel {avn} > {TOL_AV_N}")
    require(bool(k.isfinite().all()), f"{label}: non-finite f")


def _ms_per_step(run, steps, torch, warm=None) -> float:
    run(warm if warm is not None else 10)  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run(steps)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def _device_profile(run, steps, torch, warm=None) -> dict:
    """Device busy time per step from a torch.profiler (CUPTI) window over
    ``steps`` steps, beside the window's wall time per step; ``None`` where
    the profiler recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile

    run(warm if warm is not None else 10)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tic
    kernels = {
        e.key: e.self_device_time_total / steps
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    }
    busy = sum(kernels.values())
    wall_us = wall * 1e6 / steps
    return {
        "device_us": busy or None,
        "wall_us": wall_us,
        "busy_share": busy / wall_us if busy else None,
        "by_kernel_us": {k[:60]: v for k, v in kernels.items()} if busy else None,
    }


def _turns(runs: dict, order: str, steps: dict, torch, warm: dict) -> dict:
    """Time each named run in the given order of turns (e.g. "ABCCBA");
    returns {name: [ms per step, ...]} in the order taken."""
    out = {name: [] for name in runs}
    for name in order:
        out[name].append(_ms_per_step(runs[name], steps[name], torch, warm[name]))
    return out


def phase_copy_bandwidth(torch, card: str) -> float:
    """Device-to-device copy bandwidth (bytes read + written per second)
    of a 2 GiB buffer: the practical ceiling a bandwidth-bound step is
    held against."""
    n = 2**29  # fp32 elements: 2 GiB, far beyond the 50 MB L2
    src = torch.ones(n, dtype=torch.float32, device="cuda:0")
    dst = torch.empty_like(src)
    dst.copy_(src)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 20
    start.record()
    for _ in range(reps):
        dst.copy_(src)
    end.record()
    torch.cuda.synchronize()
    gbs = 2 * 4 * n * reps / (start.elapsed_time(end) * 1e-3) / 1e9
    print(f"device copy bandwidth: {gbs:.1f} GB/s (read + write, 2 GiB buffer) "
          f"| {card}")
    del src, dst
    torch.cuda.empty_cache()
    return gbs


def phase_l2_copy(torch, card: str) -> float:
    """Copy rate (bytes read + written per second of device time) of a
    4 MiB buffer, which stays in the 50 MB L2: the yardstick of the
    multi-step kernel, whose two f buffers stay there too.  A 4 MiB copy
    takes less time on the card than its launch takes on the host, so the
    rate comes from the profiler's device time, not from CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    n = 2**20  # fp32 elements: 4 MiB
    src = torch.ones(n, dtype=torch.float32, device="cuda:0")
    dst = torch.empty_like(src)
    for _ in range(10):
        dst.copy_(src)
    torch.cuda.synchronize()
    reps = 500
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            dst.copy_(src)
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    require(device_us > 0, "the profiler recorded no device time for the L2 copies")
    gbs = 2 * 4 * n * reps / (device_us * 1e-6) / 1e9
    print(f"L2-resident copy rate: {gbs:.1f} GB/s (read + write, 4 MiB buffer, "
          f"{device_us / reps:.3f} us of device time a copy) | {card}")
    return gbs


def phase_fused(torch, card: str) -> dict:
    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.ops import fused
    from lbm_tpu_torch.utils.profiling import BYTES_PER_CELL

    dev = torch.device("cuda", 0)
    rec = {"max_abs_err": 0.0, "max_abs_err_1000": 0.0, "av_rtol_1000": 0.0,
           "by_shape": {}, "timing": {}}
    shapes = ODD_SHAPES + tuple(CANONICAL_PARAMS[c].shape for c in CASES)
    # Labelled nx x ny, as the canonical cases are.  Seeds follow the
    # position in this list; new grids go in the later phases, so these
    # keep theirs.
    for seed, (ny, nx) in enumerate(shapes):
        params, obstacles, fcinv, f0 = _setup(ny, nx, seed, dev, torch)
        step = fused.FusedStep(params, obstacles, fcinv, dev)

        before = fused.LAUNCHES["lbm_fused_step"]
        k1, kav1 = _run_kernel(step, f0, 1, torch)
        kn, kavn = _run_kernel(step, f0, N_STEPS, torch)
        torch.cuda.synchronize()
        launched = fused.LAUNCHES["lbm_fused_step"] - before
        p1, pav1 = _run_plain(step, f0, 1, torch)
        pn, pavn = _run_plain(step, f0, N_STEPS, torch)
        with _torch_sum_plain(torch):
            q1, qav1 = _run_plain(step, f0, 1, torch)
            qn, qavn = _run_plain(step, f0, N_STEPS, torch)
        err1, av1 = _errs(k1, kav1, p1, pav1)
        errn, avn = _errs(kn, kavn, pn, pavn)
        old1, _ = _errs(k1, kav1, q1, qav1)
        oldn, oldavn = _errs(kn, kavn, qn, qavn)
        print(f"one-step {nx}x{ny}: 1 step max|df| {err1:.3e} (av rel {av1:.3e}); "
              f"{N_STEPS} steps max|df| {errn:.3e}, av rel {avn:.3e}; against the "
              f"torch.sum plain version: 1 step {old1:.3e}, {N_STEPS} steps {oldn:.3e}, av rel "
              f"{oldavn:.3e}; launches +{launched}")
        require(launched == 1 + N_STEPS, f"{nx}x{ny}: launch count {launched}")
        _check(f"one-step {nx}x{ny}", err1, errn, avn, kn)
        _check(f"one-step {nx}x{ny} vs torch.sum plain", old1, oldn, oldavn, kn)
        rec["by_shape"][f"{nx}x{ny}"] = {
            "err_1": err1, "err_1000": errn, "av_rtol_1000": avn,
            "sum_plain_err_1": old1, "sum_plain_err_1000": oldn,
            "sum_plain_av_rtol_1000": oldavn,
        }
        rec["max_abs_err"] = max(rec["max_abs_err"], err1)
        rec["max_abs_err_1000"] = max(rec["max_abs_err_1000"], errn)
        rec["av_rtol_1000"] = max(rec["av_rtol_1000"], avn)

        if (ny, nx) in TIMED_SHAPES:
            def kernel(n):
                _run_kernel(step, f0, n, torch)

            def checked(n):
                _run_checked(step, f0, n, torch)

            def plain(n):
                _run_plain(step, f0, n, torch)

            # Turns: plain, kernel, checked, checked, kernel, plain; the
            # mean of each pair.
            p_a = _ms_per_step(plain, 200, torch)
            k_a = _ms_per_step(kernel, 2000, torch)
            c_a = _ms_per_step(checked, 2000, torch)
            c_b = _ms_per_step(checked, 2000, torch)
            k_b = _ms_per_step(kernel, 2000, torch)
            p_b = _ms_per_step(plain, 200, torch)
            k_ms, c_ms, p_ms = (k_a + k_b) / 2, (c_a + c_b) / 2, (p_a + p_b) / 2
            kprof = _device_profile(kernel, 500, torch)
            pprof = _device_profile(plain, 50, torch)
            dev_us = kprof["device_us"]
            gbs = (BYTES_PER_CELL * ny * nx / (dev_us * 1e-6) / 1e9
                   if dev_us else None)
            rec["timing"][f"{nx}x{ny}"] = {
                "ms": k_ms, "plain_ms": p_ms, "ms_runs": [k_a, k_b],
                "plain_ms_runs": [p_a, p_b], "checked_ms_runs": [c_a, c_b],
                "kernel_profile": kprof,
                "plain_profile": pprof, "device_gbs_at_73B": gbs,
            }
            print(f"one-step {nx}x{ny}: per step, CUDA events over the launch loop: "
                  f"kernel {k_ms * 1e3:.2f} us ({k_a * 1e3:.2f}, {k_b * 1e3:.2f}), "
                  f"plain torch {p_ms * 1e3:.2f} us ({p_a * 1e3:.2f}, "
                  f"{p_b * 1e3:.2f}); kernel checked per launch {c_ms * 1e3:.2f} "
                  f"us ({c_a * 1e3:.2f}, {c_b * 1e3:.2f}) | {card}")
            print(f"one-step {nx}x{ny}: profiler: kernel device {dev_us} us/step of "
                  f"{kprof['wall_us']:.2f} us wall (busy {kprof['busy_share']}), "
                  f"{gbs} GB/s at {BYTES_PER_CELL} B/cell, by kernel "
                  f"{kprof['by_kernel_us']}; plain device {pprof['device_us']} "
                  f"us/step of {pprof['wall_us']:.2f} us wall | {card}")
    return rec


def phase_multi(torch, card: str, seed0: int) -> dict:
    """The multi-step kernel against ``chunk`` plain one-steps per launch."""
    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.ops import fused

    dev = torch.device("cuda", 0)
    rec = {"max_abs_err": 0.0, "max_abs_err_1000": 0.0, "av_rtol_1000": 0.0,
           "by_shape": {}}
    shapes = ODD_SHAPES + tuple(CANONICAL_PARAMS[c].shape for c in SMALL_CASES)
    for seed, (ny, nx) in enumerate(shapes, start=seed0):
        params, obstacles, fcinv, f0 = _setup(ny, nx, seed, dev, torch)
        ref = fused.FusedStep(params, obstacles, fcinv, dev)
        plain_n, plain_avn = _run_plain_steps(ref, f0, N_STEPS, torch)
        for chunk in MULTI_CHUNKS:
            prog = fused.MultiStep(params, obstacles, fcinv, dev, chunk)
            before = fused.LAUNCHES["lbm_multi_step"]
            k1, kav1 = _run_kernel(prog, f0, 1, torch)
            kn, kavn = _run_kernel(prog, f0, N_STEPS // chunk, torch)
            torch.cuda.synchronize()
            launched = fused.LAUNCHES["lbm_multi_step"] - before
            p1, pav1 = _run_plain(prog, f0, 1, torch)
            err1, av1 = _errs(k1, kav1, p1, pav1)
            errn, avn = _errs(kn, kavn, plain_n, plain_avn)
            label = f"multi-step {nx}x{ny} chunk {chunk}"
            print(f"{label} ({prog.nblocks} blocks): 1 launch max|df| {err1:.3e} "
                  f"(av rel {av1:.3e}); {N_STEPS} steps max|df| {errn:.3e}, av rel "
                  f"{avn:.3e}; launches +{launched}")
            require(launched == 1 + N_STEPS // chunk, f"{label}: launch count {launched}")
            _check(label, err1, errn, avn, kn)
            rec["by_shape"][f"{nx}x{ny}/{chunk}"] = {
                "err_1": err1, "err_1000": errn, "av_rtol_1000": avn,
                "blocks": prog.nblocks}
            rec["max_abs_err"] = max(rec["max_abs_err"], err1)
            rec["max_abs_err_1000"] = max(rec["max_abs_err_1000"], errn)
            rec["av_rtol_1000"] = max(rec["av_rtol_1000"], avn)
    return rec


def phase_temporal(torch, card: str, seed0: int) -> dict:
    """The temporal kernel against its plain version (the window algorithm
    in torch) and against K plain one-steps per pass."""
    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.ops import fused, schedule

    dev = torch.device("cuda", 0)
    big = CANONICAL_PARAMS["1024x1024"]
    chosen = schedule.choose_temporal(big.ny, big.nx, big.max_iters)
    require(chosen is not None, "no temporal tiling for 1024x1024 x 20000")
    rec = {"max_abs_err": 0.0, "max_abs_err_1000": 0.0, "av_rtol_1000": 0.0,
           "by_shape": {}, "chosen": chosen}
    grids = ((big.ny, big.nx, *chosen),) + TEMPORAL_SMALL
    for seed, (ny, nx, by, bx, k) in enumerate(grids, start=seed0):
        params, obstacles, fcinv, f0 = _setup(ny, nx, seed, dev, torch)
        prog = fused.TemporalStep(params, obstacles, fcinv, dev, by, bx, k)
        passes = -(-N_STEPS // k)
        before = fused.LAUNCHES["lbm_temporal_step"]
        k1, kav1 = _run_kernel(prog, f0, 1, torch)
        kn, kavn = _run_kernel(prog, f0, passes, torch)
        torch.cuda.synchronize()
        launched = fused.LAUNCHES["lbm_temporal_step"] - before
        p1, pav1 = _run_plain(prog, f0, 1, torch)
        pn, pavn = _run_plain(prog, f0, passes, torch)
        s1, sav1 = _run_plain_steps(prog, f0, k, torch)
        sn, savn = _run_plain_steps(prog, f0, passes * k, torch)
        err1, av1 = _errs(k1, kav1, p1, pav1)
        errn, avn = _errs(kn, kavn, pn, pavn)
        serr1, _ = _errs(k1, kav1, s1, sav1)
        serrn, savn_rel = _errs(kn, kavn, sn, savn)
        label = f"temporal {nx}x{ny} tile {by}x{bx} K {k}"
        print(f"{label}: against its plain version 1 pass max|df| {err1:.3e} "
              f"(av rel {av1:.3e}), {passes * k} steps max|df| {errn:.3e}, av rel "
              f"{avn:.3e}; against plain one-steps 1 pass {serr1:.3e}, "
              f"{passes * k} steps {serrn:.3e}, av rel {savn_rel:.3e}; "
              f"launches +{launched}")
        require(launched == 1 + passes, f"{label}: launch count {launched}")
        _check(label, err1, errn, avn, kn)
        _check(f"{label} vs one-steps", serr1, serrn, savn_rel, kn)
        rec["by_shape"][f"{nx}x{ny}/{by}x{bx}/K{k}"] = {
            "err_1": err1, "err_1000": errn, "av_rtol_1000": avn,
            "one_step_err_1": serr1, "one_step_err_1000": serrn,
            "one_step_av_rtol_1000": savn_rel}
        rec["max_abs_err"] = max(rec["max_abs_err"], err1, serr1)
        rec["max_abs_err_1000"] = max(rec["max_abs_err_1000"], errn, serrn)
        rec["av_rtol_1000"] = max(rec["av_rtol_1000"], avn, savn_rel)
    return rec


def _report_turns(label, times, profiles, card):
    for name, runs in times.items():
        mean = sum(runs) / len(runs)
        prof = profiles[name]
        print(f"{label} {name}: {mean * 1e3:.3f} us/step by CUDA events, turns "
              f"{[round(r * 1e3, 3) for r in runs]}; profiler device "
              f"{prof['device_us']} us/step of {prof['wall_us']:.2f} us wall (busy "
              f"{prof['busy_share']}), by kernel {prof['by_kernel_us']} | {card}")


def phase_timing(torch, card: str) -> dict:
    """Each new kernel against the one-step kernel it replaces on the main
    path, in one call, in turns (A, B, C, C, B, A)."""
    from lbm_tpu_torch.ops import fused, schedule

    dev = torch.device("cuda", 0)
    rec = {}

    # 128x128: A the bound one-step loop, B the multi-step kernel (chunk
    # 200, as the main path takes it for 40,000 steps), C a CUDA graph of
    # GRAPH_STEPS bound one-step launches, replayed.
    params, obstacles, fcinv, f0 = _setup(128, 128, 2, dev, torch)
    one = fused.FusedStep(params, obstacles, fcinv, dev)
    chunk = schedule.pick_chunk(40000)
    multi = fused.MultiStep(params, obstacles, fcinv, dev, chunk)
    gbufs = (f0.clone(), torch.empty_like(f0))
    gav = torch.empty(GRAPH_STEPS, dtype=torch.float32, device=dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        glaunch = one.bind(gbufs[0], gbufs[1], gav)
        for t in range(GRAPH_STEPS):
            glaunch(t)
    runs = {
        "A one-step loop": lambda n: _run_kernel(one, f0, n, torch),
        "B multi-step": lambda n: _run_kernel(multi, f0, n // chunk, torch),
        "C graph of one-steps": lambda n: [graph.replay()
                                           for _ in range(n // GRAPH_STEPS)],
    }
    names = list(runs)
    n = 8000
    steps = dict.fromkeys(names, n)
    warm = dict.fromkeys(names, 2 * GRAPH_STEPS)
    times = _turns(runs, [names[i] for i in (0, 1, 2, 2, 1, 0)], steps, torch, warm)
    profiles = {name: _device_profile(runs[name], 2000, torch, warm[name])
                for name in names}
    _report_turns("128x128", times, profiles, card)
    rec["128x128"] = {"times_ms": times, "profiles": profiles, "chunk": chunk,
                      "multi_blocks": multi.nblocks}
    del graph

    # 1024x1024: A the one-step kernel, B the temporal kernel at the chosen
    # tiling, C the temporal kernel at another K.
    params, obstacles, fcinv, f0 = _setup(1024, 1024, 5, dev, torch)
    one = fused.FusedStep(params, obstacles, fcinv, dev)
    by, bx, k = schedule.choose_temporal(1024, 1024, 20000)
    k_other = 4 if k != 4 else 8
    other = next((t for t in schedule.TEMPORAL_TILES
                  if schedule.temporal_smem_bytes(*t, k_other) <= schedule.SMEM_BUDGET))
    temporal = fused.TemporalStep(params, obstacles, fcinv, dev, by, bx, k)
    temporal_other = fused.TemporalStep(params, obstacles, fcinv, dev, *other, k_other)
    a, b, c = ("A one-step", f"B temporal {by}x{bx} K{k}",
               f"C temporal {other[0]}x{other[1]} K{k_other}")
    runs = {
        a: lambda n: _run_kernel(one, f0, n, torch),
        b: lambda n: _run_kernel(temporal, f0, n // k, torch),
        c: lambda n: _run_kernel(temporal_other, f0, n // k_other, torch),
    }
    steps = dict.fromkeys(runs, 800)
    warm = dict.fromkeys(runs, 16)
    times = _turns(runs, [a, b, c, c, b, a], steps, torch, warm)
    profiles = {name: _device_profile(runs[name], 400, torch, warm[name])
                for name in runs}
    _report_turns("1024x1024", times, profiles, card)

    sweep = {}
    for kk in schedule.TEMPORAL_K:
        for tile in SWEEP_TILES:
            if schedule.temporal_smem_bytes(*tile, kk) > schedule.SMEM_BUDGET:
                continue
            prog = fused.TemporalStep(params, obstacles, fcinv, dev, *tile, kk)
            sweep[f"{tile[0]}x{tile[1]} K{kk}"] = _ms_per_step(
                lambda n, prog=prog, kk=kk: _run_kernel(prog, f0, n // kk, torch),
                800, torch, 16)
    print("1024x1024 temporal tilings, us/step by CUDA events: "
          + ", ".join(f"{name} {ms * 1e3:.2f}" for name, ms in sweep.items())
          + f" | {card}")

    def plain_temporal(n):
        _run_plain(temporal, f0, n // k, torch)

    p_ms = [_ms_per_step(plain_temporal, 64, torch, 16) for _ in range(2)]
    print(f"1024x1024 plain temporal (window algorithm in torch): "
          f"{sum(p_ms) / 2 * 1e3:.2f} us/step ({p_ms[0] * 1e3:.2f}, "
          f"{p_ms[1] * 1e3:.2f}) | {card}")
    rec["1024x1024"] = {"times_ms": times, "profiles": profiles,
                        "chosen": [by, bx, k], "other": [*other, k_other],
                        "tile_sweep_ms": sweep,
                        "plain_temporal_ms_runs": p_ms}

    # The multi-step kernel's plain version at 128x128: plain one-steps.
    params, obstacles, fcinv, f0 = _setup(128, 128, 2, dev, torch)
    multi = fused.MultiStep(params, obstacles, fcinv, dev, 8)
    p_ms = [_ms_per_step(lambda n: _run_plain(multi, f0, n // 8, torch), 200,
                         torch, 16) for _ in range(2)]
    rec["128x128"]["plain_multi_ms_runs"] = p_ms
    print(f"128x128 plain multi-step (chunk plain one-steps): "
          f"{sum(p_ms) / 2 * 1e3:.2f} us/step | {card}")
    return rec


def _golden_prefix(case: str, steps: int, out: pathlib.Path) -> pathlib.Path:
    """The vendored golden av_vels, cut to ``steps`` rows."""
    lines = (GOLDENS / f"{case}.fp64gen_av_vels.dat").read_text().splitlines()
    require(len(lines) >= steps, f"{case}: golden has {len(lines)} < {steps} steps")
    out.write_text("\n".join(lines[:steps]) + "\n")
    return out


def _expected_launches(kind: str, args: tuple, steps: int) -> dict:
    """The launches per kernel that ``steps`` steps of this schedule make:
    one per chunk (multi-step), per K steps (temporal) or per step."""
    name, per = {"multi": ("lbm_multi_step", args[:1]),
                 "temporal": ("lbm_temporal_step", args[2:]),
                 "fused": ("lbm_fused_step", (1,))}[kind]
    out = {"lbm_fused_step": 0, "lbm_multi_step": 0, "lbm_temporal_step": 0}
    out[name] = steps // per[0]
    return out


def phase_main(torch, card: str) -> dict:
    from lbm_tpu_torch import cli
    from lbm_tpu_torch.checker import check_files
    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.geometry import canonical_obstacles, write_obstacle_file
    from lbm_tpu_torch.ops import fused, schedule

    rec = {"cases": {}, "launches": dict.fromkeys(fused.LAUNCHES, 0)}
    runs = [(case, None) for case in CASES] + list(ONE_STEP_RUNS)
    for case, max_iters in runs:
        params = CANONICAL_PARAMS[case]
        steps = params.max_iters if max_iters is None else max_iters
        kind, args = schedule.choose_schedule(params.ny, params.nx, steps)
        want_kind = ("fused" if max_iters is not None
                     else "temporal" if case == "1024x1024" else "multi")
        require(kind == want_kind, f"{case} x {steps}: chooser took {kind}, "
                                   f"not {want_kind}")
        label = case if max_iters is None else f"{case}x{steps}"
        d = WORK / label
        d.mkdir(parents=True, exist_ok=True)
        params.to_file(d / f"input_{case}.params")
        write_obstacle_file(d / f"obstacles_{case}.dat", canonical_obstacles(case))
        argv = ["run", str(d / f"input_{case}.params"), str(d / f"obstacles_{case}.dat"),
                "--output-dir", str(d)]
        if max_iters is not None:
            argv += ["--max-iters", str(max_iters)]
        buf = io.StringIO()
        fused.reset_launches()
        tic = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        wall = time.perf_counter() - tic
        launches = dict(fused.LAUNCHES)
        out = buf.getvalue()
        print("  " + out.strip().replace("\n", "\n  "))
        require(rc == 0, f"{label}: cli run returned {rc}")
        want = _expected_launches(kind, args, steps)
        require(launches == want, f"{label}: launches {launches}, expected {want}")
        for name, count in launches.items():
            rec["launches"][name] += count
        elapsed = float(re.search(r"Elapsed time:\s+([0-9.]+)", out).group(1))
        full_fs = max_iters is None and case in FINAL_STATE_GOLDENS
        report = io.StringIO()
        with contextlib.redirect_stdout(report):
            res = check_files(
                ref_av_vels=str(_golden_prefix(case, steps, d / "golden_av_vels.dat")),
                ref_final_state=(str(GOLDENS / f"{case}.fp64gen_final_state.dat")
                                 if full_fs else None),
                av_vels=str(d / "av_vels.dat"),
                final_state=str(d / "final_state.dat") if full_fs else None,
            )
        print("  " + report.getvalue().strip().replace("\n", "\n  "))
        require(res.ok, f"{label}: checker failed against tests/goldens")
        mlups = params.nx * params.ny * steps / elapsed / 1e6
        worst = {k: abs(v) for k, v in res.worst_pct.items()}
        rec["cases"][label] = {"steps": steps, "kernel": kind, "schedule": list(args),
                               "launches": launches, "elapsed_s": elapsed,
                               "wall_s": wall, "mlups": mlups, "worst_pct": worst}
        print(f"case {label}: {steps} steps through {kind} {list(args)}, launches "
              f"{launches}, {elapsed:.6f} s timed ({wall:.3f} s wall incl. build "
              f"check and writers), {mlups:.1f} MLUPS, worst deviation "
              + ", ".join(f"{k} {v:.4f}%" for k, v in worst.items())
              + f" | {card}", flush=True)
    require(all(v > 0 for v in rec["launches"].values()),
            f"a kernel of the main path never launched: {rec['launches']}")
    return rec


def phase_repro() -> None:
    import dataclasses

    import numpy as np

    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.geometry import canonical_obstacles
    from lbm_tpu_torch.ops import fused
    from lbm_tpu_torch.runtime import Simulator

    for case, kind in (("1024x1024", fused.TemporalStep), ("128x128", fused.MultiStep)):
        params = dataclasses.replace(CANONICAL_PARAMS[case], max_iters=N_STEPS)
        sim = Simulator(params, canonical_obstacles(case), device="cuda:0")
        require(isinstance(sim.program, kind),
                f"{case} x {N_STEPS} runs {type(sim.program).__name__}")
        a, b = sim.run(readback="state"), sim.run(readback="state")
        same_av = np.array_equal(a.av_vels.view(np.uint32), b.av_vels.view(np.uint32))
        same_f = np.array_equal(a.f.view(np.uint32), b.f.view(np.uint32))
        print(f"{case} x {N_STEPS} through {kind.__name__} twice: av_vels bitwise "
              f"equal {same_av}, f bitwise equal {same_f}")
        require(same_av and same_f, f"{case}: two identical runs differ")


def _bound_ms(bytes_moved: float, ops: float) -> tuple[float, str]:
    """The least time for the work on this card (published rates), and
    which of the two bounds it."""
    t_bytes, t_ops = bytes_moved / MEM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    with phase("1 environment"):
        card = phase_env(torch)
    with phase("2 build"):
        phase_build()
    with phase("3 kernels vs plain torch, and times"):
        frec = phase_fused(torch, card)
        mrec = phase_multi(torch, card, seed0=len(ODD_SHAPES) + len(CASES))
        trec = phase_temporal(torch, card, seed0=2 * len(ODD_SHAPES) + len(CASES)
                              + len(SMALL_CASES))
        timing = phase_timing(torch, card)
        copy_gbs = phase_copy_bandwidth(torch, card)
        l2_gbs = phase_l2_copy(torch, card)
    with phase("4 main path: four canonical cases and the one-step branch "
               "through the CLI"):
        main_rec = phase_main(torch, card)
    with phase("5 reproducibility"):
        phase_repro()

    from lbm_tpu_torch.ops.fused import window_bytes_per_update
    from lbm_tpu_torch.utils.profiling import BYTES_PER_CELL

    launches = main_rec["launches"]
    big, small = frec["timing"]["1024x1024"], frec["timing"]["128x128"]
    t128, t1024 = timing["128x128"], timing["1024x1024"]
    by, bx, k = t1024["chosen"]
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    cells_big, cells_small = 1024 * 1024, 128 * 128
    t_names = list(t1024["times_ms"])
    m_names = list(t128["times_ms"])

    fused_bound, fused_by = _bound_ms(BYTES_PER_CELL * cells_big,
                                      OPS_PER_UPDATE * cells_big)
    chunk = t128["chunk"]
    multi_bound, multi_by = _bound_ms(BYTES_PER_CELL * cells_small / chunk,
                                      OPS_PER_UPDATE * cells_small)
    temp_bound, temp_by = _bound_ms(BYTES_PER_CELL * cells_big / k,
                                    OPS_PER_UPDATE * cells_big)
    window_b = window_bytes_per_update(by, bx, k) * cells_big
    kernels = {"kernels": [
        {
            "name": "lbm_fused_step",
            "route": "cuda",
            "source": "lbm_tpu_torch/csrc/lbm_step.cu",
            "replaces": "lbm_tpu/ops/fused.py:361",
            "also_replaces": ["lbm_tpu/ops/fused.py:347"],
            "launches": launches["lbm_fused_step"],
            "max_abs_err": frec["max_abs_err"],
            "max_abs_err_1000_steps": frec["max_abs_err_1000"],
            "av_rtol_1000_steps": frec["av_rtol_1000"],
            "errors_by_shape": frec["by_shape"],
            "per": "step",
            "shape": "1024x1024",
            "ms": big["ms"],
            "plain_ms": big["plain_ms"],
            "bound_ms": fused_bound,
            "bound_by": fused_by,
            "bound_ms_at_copy_rate": BYTES_PER_CELL * cells_big / (copy_gbs * 1e9) * 1e3,
            "library_ms": None,
            "ms_turns_1024x1024": t1024["times_ms"][t_names[0]],
            "ms_128x128": small["ms"],
            "plain_ms_128x128": small["plain_ms"],
            "checked_ms_128x128": mean(small["checked_ms_runs"]),
            "device_us_1024x1024": big["kernel_profile"]["device_us"],
            "device_us_128x128": small["kernel_profile"]["device_us"],
            "plain_device_us_1024x1024": big["plain_profile"]["device_us"],
            "device_gbs_1024x1024": big["device_gbs_at_73B"],
            "graph_ms_128x128": mean(t128["times_ms"][m_names[2]]),
            "graph_device_us_128x128": t128["profiles"][m_names[2]]["device_us"],
            "card": card,
        },
        {
            "name": "lbm_multi_step",
            "route": "cuda",
            "source": "lbm_tpu_torch/csrc/lbm_multi.cu",
            "replaces": "lbm_tpu/ops/fused.py:565",
            "launches": launches["lbm_multi_step"],
            "max_abs_err": mrec["max_abs_err"],
            "max_abs_err_1000_steps": mrec["max_abs_err_1000"],
            "av_rtol_1000_steps": mrec["av_rtol_1000"],
            "errors_by_shape": mrec["by_shape"],
            "per": "step",
            "shape": f"128x128, chunk {chunk}",
            "ms": mean(t128["times_ms"][m_names[1]]),
            "ms_turns": t128["times_ms"][m_names[1]],
            "device_us": t128["profiles"][m_names[1]]["device_us"],
            "plain_ms": mean(t128["plain_multi_ms_runs"]),
            "bound_ms": multi_bound,
            "bound_by": multi_by,
            "bound_ms_l2": BYTES_PER_CELL * cells_small / (l2_gbs * 1e9) * 1e3,
            "library_ms": None,
            "one_step_loop_ms_turns": t128["times_ms"][m_names[0]],
            "blocks": t128["multi_blocks"],
            "card": card,
        },
        {
            "name": "lbm_temporal_step",
            "route": "cuda",
            "source": "lbm_tpu_torch/csrc/lbm_temporal.cu",
            "replaces": "lbm_tpu/ops/fused.py:799",
            "launches": launches["lbm_temporal_step"],
            "max_abs_err": trec["max_abs_err"],
            "max_abs_err_1000_steps": trec["max_abs_err_1000"],
            "av_rtol_1000_steps": trec["av_rtol_1000"],
            "errors_by_shape": trec["by_shape"],
            "per": "step",
            "shape": f"1024x1024, tile {by}x{bx}, K {k}",
            "ms": mean(t1024["times_ms"][t_names[1]]),
            "ms_turns": t1024["times_ms"][t_names[1]],
            "device_us": t1024["profiles"][t_names[1]]["device_us"],
            "other_k": {"name": t_names[2], "ms_turns": t1024["times_ms"][t_names[2]],
                        "device_us": t1024["profiles"][t_names[2]]["device_us"]},
            "plain_ms": mean(t1024["plain_temporal_ms_runs"]),
            "bound_ms": temp_bound,
            "bound_by": temp_by,
            "bound_ms_window_bytes": window_b / MEM_BYTES_PER_S * 1e3,
            "library_ms": None,
            "card": card,
        },
    ], "copy_gbs": copy_gbs, "l2_copy_gbs": l2_gbs, "cases": main_rec["cases"]}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

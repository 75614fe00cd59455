#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``lbm_tpu_torch``).

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

Phases, each printed with its seconds:

1. environment: the card (``nvidia-smi`` name and power limit), torch, nvcc;
2. build: ``nvcc`` compiles ``lbm_tpu_torch/csrc/lbm_step.cu`` for sm_90a;
3. the kernel against its plain torch version on the card, on seeded
   inputs that exercise the body-force gate, at every grid the main path
   gives it plus two with odd block edges (1 step: max |df| <= 1e-6;
   1000 steps: max |df| <= 1e-5 and av rtol <= 1e-4); the time per step
   of each at 128x128 and 1024x1024, by CUDA events over the launch loop
   and as device time from torch.profiler; the card's copy bandwidth;
4. the main path: the four canonical cases, full length, through the
   port's CLI (``run``), checked against ``tests/goldens/`` at 1%, with
   the kernel's launch count reset before and read after;
5. reproducibility: 1024x1024 x 1000 steps twice, bitwise-equal av_vels.

Any failure raises (non-zero exit, no result line).  On success the line
before the last is the kernels' JSON record and the last line is
``{"ok": true, "device": {...}}``.  Needs no JAX and no network.
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
FINAL_STATE_GOLDENS = ("128x128", "128x256")
TOL_F_1, TOL_F_N, TOL_AV_N, N_STEPS = 1e-6, 1e-5, 1e-4, 1000


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
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {line.strip()}")


def _run_kernel(step, f0, steps, torch):
    """``steps`` kernel launches ping-pong from ``f0``, bound as the main
    path binds them: (f, av[steps])."""
    bufs = (f0.clone(), torch.empty_like(f0))
    av = torch.empty(steps, dtype=torch.float32, device=f0.device)
    launch = step.bind(bufs[0], bufs[1], av)
    for t in range(steps):
        launch(t)
    return bufs[steps & 1], av


def _run_checked(step, f0, steps, torch):
    """As :func:`_run_kernel`, but each launch through ``step(...)``, which
    checks its tensors on every call: the cost that binding removes."""
    a, b = f0.clone(), torch.empty_like(f0)
    av = torch.empty(steps, dtype=torch.float32, device=f0.device)
    for t in range(steps):
        step(a, b, av, t)
        a, b = b, a
    return a, av


def _run_plain(step, f0, steps, torch):
    f, avs = f0, []
    for _ in range(steps):
        f, a = step.plain(f)
        avs.append(a)
    return f, torch.stack(avs)


def _ms_per_step(run, steps, torch) -> float:
    run(10)  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run(steps)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def _device_profile(run, steps, torch) -> dict:
    """Device busy time per step from a torch.profiler (CUPTI) window over
    ``steps`` steps, beside the window's wall time per step; ``None`` where
    the profiler recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile

    run(10)  # warm-up
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


def phase_kernel(torch, card: str) -> dict:
    import numpy as np

    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.geometry import free_cells_of
    from lbm_tpu_torch.ops import fused
    from lbm_tpu_torch.testing import gate_case
    from lbm_tpu_torch.utils.profiling import BYTES_PER_CELL

    dev = torch.device("cuda", 0)
    rec = {"max_abs_err": 0.0, "max_abs_err_1000": 0.0, "av_rtol_1000": 0.0,
           "by_shape": {}, "timing": {}}
    shapes = ODD_SHAPES + tuple(CANONICAL_PARAMS[c].shape for c in CASES)
    # Labelled nx x ny, as the canonical cases are.
    for seed, (ny, nx) in enumerate(shapes):
        params, obstacles, f0_np = gate_case(ny, nx, seed)
        fcinv = np.float32(1.0) / np.float32(free_cells_of(obstacles))
        step = fused.FusedStep(params, obstacles, fcinv, dev)
        f0 = torch.from_numpy(f0_np).to(dev)

        before = fused.LAUNCHES
        k1, kav1 = _run_kernel(step, f0, 1, torch)
        kn, kavn = _run_kernel(step, f0, N_STEPS, torch)
        torch.cuda.synchronize()
        launched = fused.LAUNCHES - before
        p1, pav1 = _run_plain(step, f0, 1, torch)
        pn, pavn = _run_plain(step, f0, N_STEPS, torch)
        err1 = (k1 - p1).abs().max().item()
        errn = (kn - pn).abs().max().item()
        av1 = ((kav1 - pav1).abs() / pav1.abs()).max().item()
        avn = ((kavn - pavn).abs() / pavn.abs()).max().item()
        print(f"{nx}x{ny}: 1 step max|df| {err1:.3e} (av rel {av1:.3e}); "
              f"{N_STEPS} steps max|df| {errn:.3e}, av rel {avn:.3e}; "
              f"launches +{launched}")
        require(launched == 1 + N_STEPS, f"{nx}x{ny}: launch count {launched}")
        require(err1 <= TOL_F_1, f"{nx}x{ny}: 1-step max|df| {err1} > {TOL_F_1}")
        require(errn <= TOL_F_N, f"{nx}x{ny}: {N_STEPS}-step max|df| {errn} > {TOL_F_N}")
        require(avn <= TOL_AV_N, f"{nx}x{ny}: {N_STEPS}-step av rel {avn} > {TOL_AV_N}")
        require(bool(torch.isfinite(kn).all()), f"{nx}x{ny}: non-finite f")
        rec["by_shape"][f"{nx}x{ny}"] = {"err_1": err1, "err_1000": errn,
                                          "av_rtol_1000": avn}
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
            print(f"{nx}x{ny}: per step, CUDA events over the launch loop: kernel "
                  f"{k_ms * 1e3:.2f} us ({k_a * 1e3:.2f}, {k_b * 1e3:.2f}), "
                  f"plain torch {p_ms * 1e3:.2f} us ({p_a * 1e3:.2f}, "
                  f"{p_b * 1e3:.2f}); kernel checked per launch {c_ms * 1e3:.2f} "
                  f"us ({c_a * 1e3:.2f}, {c_b * 1e3:.2f}) | {card}")
            print(f"{nx}x{ny}: profiler: kernel device {dev_us} us/step of "
                  f"{kprof['wall_us']:.2f} us wall (busy {kprof['busy_share']}), "
                  f"{gbs} GB/s at {BYTES_PER_CELL} B/cell, by kernel "
                  f"{kprof['by_kernel_us']}; plain device {pprof['device_us']} "
                  f"us/step of {pprof['wall_us']:.2f} us wall | {card}")
    return rec


def _golden_prefix(case: str, steps: int, out: pathlib.Path) -> pathlib.Path:
    """The vendored golden av_vels, cut to ``steps`` rows."""
    lines = (GOLDENS / f"{case}.fp64gen_av_vels.dat").read_text().splitlines()
    require(len(lines) >= steps, f"{case}: golden has {len(lines)} < {steps} steps")
    out.write_text("\n".join(lines[:steps]) + "\n")
    return out


def phase_main(torch, card: str) -> dict:
    from lbm_tpu_torch import cli
    from lbm_tpu_torch.checker import check_files
    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.geometry import canonical_obstacles, write_obstacle_file
    from lbm_tpu_torch.ops import fused

    rec = {"cases": {}}
    total_steps = 0
    fused.LAUNCHES = 0
    for case in CASES:
        params = CANONICAL_PARAMS[case]
        d = WORK / case
        d.mkdir(parents=True, exist_ok=True)
        params.to_file(d / f"input_{case}.params")
        write_obstacle_file(d / f"obstacles_{case}.dat", canonical_obstacles(case))
        buf = io.StringIO()
        tic = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["run", str(d / f"input_{case}.params"),
                           str(d / f"obstacles_{case}.dat"), "--output-dir", str(d)])
        wall = time.perf_counter() - tic
        out = buf.getvalue()
        print("  " + out.strip().replace("\n", "\n  "))
        require(rc == 0, f"{case}: cli run returned {rc}")
        elapsed = float(re.search(r"Elapsed time:\s+([0-9.]+)", out).group(1))
        total_steps += params.max_iters
        full_fs = case in FINAL_STATE_GOLDENS
        report = io.StringIO()
        with contextlib.redirect_stdout(report):
            res = check_files(
                ref_av_vels=str(_golden_prefix(case, params.max_iters,
                                               d / "golden_av_vels.dat")),
                ref_final_state=(str(GOLDENS / f"{case}.fp64gen_final_state.dat")
                                 if full_fs else None),
                av_vels=str(d / "av_vels.dat"),
                final_state=str(d / "final_state.dat") if full_fs else None,
            )
        print("  " + report.getvalue().strip().replace("\n", "\n  "))
        require(res.ok, f"{case}: checker failed against tests/goldens")
        mlups = params.nx * params.ny * params.max_iters / elapsed / 1e6
        worst = {k: abs(v) for k, v in res.worst_pct.items()}
        rec["cases"][case] = {"steps": params.max_iters, "elapsed_s": elapsed,
                              "wall_s": wall, "mlups": mlups, "worst_pct": worst}
        print(f"case {case}: {params.max_iters} steps, {elapsed:.6f} s timed "
              f"({wall:.3f} s wall incl. build check and writers), "
              f"{mlups:.1f} MLUPS, worst deviation "
              + ", ".join(f"{k} {v:.4f}%" for k, v in worst.items())
              + f" | {card}", flush=True)
    rec["launches"] = fused.LAUNCHES
    require(rec["launches"] == total_steps,
            f"main path launched the kernel {rec['launches']} times "
            f"for {total_steps} steps")
    return rec


def phase_repro() -> None:
    import dataclasses

    import numpy as np

    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.geometry import canonical_obstacles
    from lbm_tpu_torch.runtime import Simulator

    params = dataclasses.replace(CANONICAL_PARAMS["1024x1024"], max_iters=N_STEPS)
    sim = Simulator(params, canonical_obstacles("1024x1024"), device="cuda:0")
    a, b = sim.run(readback="state"), sim.run(readback="state")
    same_av = np.array_equal(a.av_vels.view(np.uint32), b.av_vels.view(np.uint32))
    same_f = np.array_equal(a.f.view(np.uint32), b.f.view(np.uint32))
    print(f"1024x1024 x {N_STEPS} twice: av_vels bitwise equal {same_av}, "
          f"f bitwise equal {same_f}")
    require(same_av and same_f, "two identical runs differ")


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
    with phase("3 kernel vs plain torch"):
        krec = phase_kernel(torch, card)
        krec["copy_gbs"] = phase_copy_bandwidth(torch, card)
    with phase("4 main path: four canonical cases through the CLI"):
        mrec = phase_main(torch, card)
    with phase("5 reproducibility"):
        phase_repro()

    big = krec["timing"]["1024x1024"]
    small = krec["timing"]["128x128"]
    kernels = {"kernels": [{
        "name": "lbm_fused_step",
        "route": "cuda",
        "source": "lbm_tpu_torch/csrc/lbm_step.cu",
        "replaces": "lbm_tpu/ops/fused.py:361",
        "also_replaces": ["lbm_tpu/ops/fused.py:347"],
        "launches": mrec["launches"],
        "max_abs_err": krec["max_abs_err"],
        "max_abs_err_1000_steps": krec["max_abs_err_1000"],
        "av_rtol_1000_steps": krec["av_rtol_1000"],
        "errors_by_shape": krec["by_shape"],
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "shape": "1024x1024",
        "ms_128x128": small["ms"],
        "plain_ms_128x128": small["plain_ms"],
        "checked_ms_128x128": sum(small["checked_ms_runs"]) / 2,
        "device_us_1024x1024": big["kernel_profile"]["device_us"],
        "device_us_128x128": small["kernel_profile"]["device_us"],
        "plain_device_us_1024x1024": big["plain_profile"]["device_us"],
        "device_gbs_1024x1024": big["device_gbs_at_73B"],
        "copy_gbs": krec["copy_gbs"],
        "cases": mrec["cases"],
        "card": card,
    }]}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""16-bit storage of f in the temporal kernel: measure, then decide.  The
port of ``tools/fp16_experiment.py``.

The temporal kernel spends about half its step in its window's loads and
stores (``tools/ablate_step.py``; PERF.md), and f is 36 bytes a cell.
Storing f as float16 or bfloat16 in device memory halves both; all
arithmetic stays fp32 (widen on load, round once per K-step pass on
store: ``TemporalStep(storage=...)``, ``csrc/lbm_temporal16.cu``).  The
risk is the per-pass rounding compounding over the reference horizons
(80,000 steps at 256^2 is the longest) against the checker's 1% relative
tolerance.  fp32 stays the production storage; this tool only measures.

Two subcommands:

* ``drift --case C --storage float16|bfloat16|float32`` — run the
  temporal program with that storage for the case's full length, at the
  tile ``schedule.choose_temporal`` gives, and compare every av value with
  the vendored fp64 golden (``tests/goldens/<case>.fp64gen_av_vels.dat``).
  Prints the max, 99th-percentile and final drift and PASS/FAIL against
  1%; exits 0 on a pass, 1 otherwise.  ``LBM_DEVICE=cpu`` runs the plain
  version (correctness only).
* ``time --grid NYxNX [--by B --bx X --k K] [--steps N] [--repeats R]`` —
  best-of-repeats µs/step for fp32, bfloat16 and float16 storage at the
  same tile (the chooser's by default), by the autotuner's timer
  (:func:`lbm_tpu_torch.tuning.time_temporal_candidate`), on the card.

    python -m lbm_tpu_torch.tools.fp16_experiment drift --case 256x256 --storage float16
    python -m lbm_tpu_torch.tools.fp16_experiment time --grid 1024x1024
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

from lbm_tpu_torch import tuning
from lbm_tpu_torch.config import CANONICAL_PARAMS, LBMParams
from lbm_tpu_torch.geometry import canonical_obstacles, channel_box, free_cells_of
from lbm_tpu_torch.ops import schedule
from lbm_tpu_torch.ops.fused import TemporalStep
from lbm_tpu_torch.ops.reference import init_cells
from lbm_tpu_torch.runtime import select_device

GOLDEN_DIR = pathlib.Path(__file__).resolve().parents[2] / "tests" / "goldens"
TOL_PCT = 1.0  # the reference checker's pass bound
STORAGES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}


def golden_av(case: str, max_iters: int) -> np.ndarray:
    """The vendored full-length fp64 golden av series of ``case``."""
    path = GOLDEN_DIR / f"{case}.fp64gen_av_vels.dat"
    g = np.loadtxt(path, usecols=[1]) if path.is_file() else np.empty(0)
    if g.size < max_iters:
        raise SystemExit(f"no {max_iters}-step golden for {case} in {GOLDEN_DIR}")
    return g[:max_iters]


def drift_tile(params: LBMParams, device: torch.device) -> tuple[int, int, int]:
    """The tile and K the run takes: the chooser's temporal pick for the
    grid and its full length."""
    picked = schedule.choose_temporal(params.ny, params.nx, params.max_iters,
                                      tuning.device_kind(device))
    if picked is None:
        raise SystemExit(f"{params.ny}x{params.nx} x {params.max_iters}: no temporal "
                         "tile divides the grid with a K that divides the steps")
    return picked


def storage_av(params: LBMParams, obstacles: np.ndarray, storage: torch.dtype,
               device: torch.device, tile: tuple[int, int, int] | None = None,
               ) -> np.ndarray:
    """The av series of ``params.max_iters`` steps of the temporal program
    with f stored as ``storage``, from the uniform state rounded to it, at
    ``tile`` = (by, bx, K) (:func:`drift_tile` by default)."""
    by, bx, k = tile if tile is not None else drift_tile(params, device)
    if params.max_iters % k:
        raise ValueError(f"K={k} does not divide {params.max_iters} steps")
    fcinv = np.float32(1.0) / np.float32(free_cells_of(obstacles))
    prog = TemporalStep(params, obstacles, fcinv, device, by, bx, k, storage=storage)
    f0 = init_cells(params, device).to(storage)
    av = torch.empty(params.max_iters, dtype=torch.float32, device=device)
    launch = prog.bind(f0, torch.empty_like(f0), av)
    for i in range(params.max_iters // k):
        launch(i)
    return av.cpu().numpy().astype(np.float64)


def cmd_drift(case: str, storage_name: str) -> int:
    params = CANONICAL_PARAMS[case]
    obstacles = canonical_obstacles(case)
    golden = golden_av(case, params.max_iters)
    device = select_device()
    by, bx, k = tile = drift_tile(params, device)
    print(f"{case}: temporal (BY={by}, BX={bx}, K={k}) storage={storage_name}, "
          f"{params.max_iters} steps on {tuning.device_kind(device)}", flush=True)
    tic = time.perf_counter()
    av = storage_av(params, obstacles, STORAGES[storage_name], device, tile)
    print(f"  ran in {time.perf_counter() - tic:.3f} s (wall, incl. set-up)")
    pct = np.abs((golden - av) / golden) * 100.0
    finite = bool(np.isfinite(av).all())
    # Re = av * reynolds_dim / nu, with the last av of the run.
    re_run = float(av[-1]) * params.reynolds_dim / params.viscosity
    re_golden = float(golden[-1]) * params.reynolds_dim / params.viscosity
    ok = finite and float(pct.max()) < TOL_PCT
    print(json.dumps({
        "case": case, "storage": storage_name, "by": by, "bx": bx, "k": k,
        "steps": params.max_iters, "max_pct": float(pct.max()),
        "argmax_step": int(np.argmax(np.nan_to_num(pct, nan=np.inf))),
        "p99_pct": float(np.percentile(pct, 99)), "final_pct": float(pct[-1]),
        "reynolds": re_run, "reynolds_golden": re_golden, "tol_pct": TOL_PCT,
        "finite": finite, "pass": ok,
    }))
    return 0 if ok else 1


def cmd_time(grid: str, by: int | None, bx: int | None, k: int | None, steps: int,
             repeats: int) -> int:
    try:
        ny, nx = (int(v) for v in grid.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--grid must be NYxNX, got {grid!r}")
    params = LBMParams(nx, ny, steps, 10, 0.1, 0.01, 1.85)
    obstacles = channel_box(nx, ny)
    if (by, bx, k) == (None, None, None):
        picked = schedule.choose_temporal(ny, nx, steps)
        if picked is None:
            raise SystemExit(f"{grid}: no temporal tile for {steps} steps; pass "
                             "--by/--bx/--k")
        by, bx, k = picked
    elif None in (by, bx, k):
        raise SystemExit("give all of --by, --bx and --k, or none")
    steps -= steps % k
    if steps < k:
        raise SystemExit(f"--steps must be at least K={k}")
    print(f"{grid}: (BY={by}, BX={bx}, K={k}), {steps} steps x {repeats} repeats on "
          f"{tuning.default_device_kind()}", flush=True)
    out = {}
    for name, storage in STORAGES.items():
        us = tuning.time_temporal_candidate(params, obstacles, by, bx, k, steps, repeats,
                                            storage=storage)
        out[name] = us
        print(json.dumps({
            "grid": grid, "storage": name, "by": by, "bx": bx, "k": k, "steps": steps,
            "us_per_step": us, "glups": ny * nx / us / 1e3 if us else None,
        }), flush=True)
    for n16 in ("bfloat16", "float16"):
        if out["float32"] and out[n16]:
            print(json.dumps({"grid": grid,
                              f"speedup_{n16}_vs_fp32": out["float32"] / out[n16]}))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_drift = sub.add_parser("drift")
    p_drift.add_argument("--case", required=True, choices=sorted(CANONICAL_PARAMS))
    p_drift.add_argument("--storage", default="float16", choices=list(STORAGES))
    p_time = sub.add_parser("time")
    p_time.add_argument("--grid", required=True, help="NYxNX")
    p_time.add_argument("--by", type=int, default=None)
    p_time.add_argument("--bx", type=int, default=None)
    p_time.add_argument("--k", type=int, default=None)
    p_time.add_argument("--steps", type=int, default=4800)
    p_time.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args(argv)
    if args.cmd == "drift":
        return cmd_drift(args.case, args.storage)
    if args.repeats < 1:
        raise SystemExit(f"--repeats must be >= 1, got {args.repeats}")
    return cmd_time(args.grid, args.by, args.bx, args.k, args.steps, args.repeats)


if __name__ == "__main__":
    sys.exit(main())

"""Run the canonical cases and print a results table (the port of
``tools/bench_all.py``).

Per case: the timed seconds (best of ``--repeats``, the reference's
tic..toc) and the wall seconds of that run (``Simulator.run`` with the
fields readback and its reconstruction, on the card inside the timer),
MLUPS, the speed-up over the
reference's published Tesla K20m time (per step where ``--max-iters`` cuts
the run), the checker's deviation of av_vels from the goldens (the
reference's ``<case>.av_vels.dat`` in ``--reference-check DIR`` where it
is there, else the vendored fp64 ones in ``tests/goldens/``) and the
Reynolds number.  Exits 1 where a case deviates more than
``--tolerance`` or is not finite.

Usage (from the repository root; on the card unless ``LBM_DEVICE=cpu``)::

    python -m lbm_tpu_torch.tools.bench_all [--repeats N] [--markdown]
    LBM_DEVICE=cpu python -m lbm_tpu_torch.tools.bench_all --case 128x128 --max-iters 20
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time

import numpy as np
import torch

from lbm_tpu_torch.config import CANONICAL_PARAMS
from lbm_tpu_torch.geometry import canonical_obstacles
from lbm_tpu_torch.runtime import Simulator, select_device

# The reference's OpenCL GPU times (Tesla K20m, report.odt / BASELINE.md).
REFERENCE_SECONDS = {
    "128x128": 0.684,
    "128x256": 1.203,
    "256x256": 4.012,
    "1024x1024": 11.69,
}
VENDORED_DIR = pathlib.Path(__file__).resolve().parents[2] / "tests" / "goldens"


def golden_series(case: str,
                  reference: pathlib.Path | None) -> tuple[np.ndarray, str] | None:
    """The golden av_vels of ``case`` and where it came from: the
    reference's in ``reference`` where it is there, else the vendored fp64
    series."""
    paths = [VENDORED_DIR / f"{case}.fp64gen_av_vels.dat"]
    if reference is not None:
        paths.insert(0, reference / f"{case}.av_vels.dat")
    for path in paths:
        if path.exists():
            return np.loadtxt(path, usecols=[1], ndmin=1), str(path)
    return None


def bench_case(case: str, repeats: int, max_iters: int | None, device,
               reference: pathlib.Path | None = None) -> dict:
    params = CANONICAL_PARAMS[case]
    full = params.max_iters
    if max_iters is not None:
        params = dataclasses.replace(params, max_iters=max_iters)
    steps = params.max_iters
    sim = Simulator(params, canonical_obstacles(case), device=device)
    best, best_wall = None, None
    for _ in range(repeats):
        tic = time.perf_counter()
        res = sim.run(readback="fields")
        wall = time.perf_counter() - tic
        if best is None or res.elapsed < best.elapsed:
            best, best_wall = res, wall
    row = {"case": case, "iters": steps, "seconds": best.elapsed, "wall_s": best_wall,
           "mlups": best.mlups,
           "speedup": REFERENCE_SECONDS[case] * steps / full / best.elapsed,
           "reynolds": best.reynolds,
           "av_finite": bool(np.isfinite(best.av_vels).all()),
           "max_diff_pct": float("nan"), "golden": None}
    golden = golden_series(case, reference)
    if golden is not None and golden[0].size >= steps:
        ref = golden[0][:steps]
        row["max_diff_pct"] = float(
            (np.abs((ref - best.av_vels) / ref) * 100).max(initial=0.0))
        row["golden"] = golden[1]
    return row


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--markdown", action="store_true")
    parser.add_argument("--tolerance", type=float, default=1.0, metavar="PCT",
                        help="fail (exit 1) if any case deviates more than this")
    parser.add_argument("--case", action="append", choices=sorted(REFERENCE_SECONDS),
                        help="a case to run (repeatable; default all four)")
    parser.add_argument("--max-iters", type=int, default=None,
                        help="run a prefix of each case")
    parser.add_argument("--reference-check", type=pathlib.Path, default=None,
                        metavar="DIR", help="the reference checkout's check/ "
                        "directory, whose goldens take precedence")
    args = parser.parse_args(argv)
    if args.repeats < 1:
        parser.error(f"--repeats must be >= 1, got {args.repeats}")

    device = select_device()
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    rows = [bench_case(case, args.repeats, args.max_iters, device, args.reference_check)
            for case in args.case or list(REFERENCE_SECONDS)]
    if args.markdown:
        print(f"Device: {name}")
        print("| Case | iters | seconds | wall s | MLUPS | vs K20m | max diff | Re |")
        print("|---|---|---|---|---|---|---|---|")
        for r in rows:
            print(f"| {r['case']} | {r['iters']} | {r['seconds']:.6f} | {r['wall_s']:.3f} "
                  f"| {r['mlups']:.1f} | {r['speedup']:.1f}x | {r['max_diff_pct']:.4f}% "
                  f"| {r['reynolds']:.6f} |")
    else:
        for r in rows:
            print(f"{r['case']:>10}: {r['seconds']:.6f}s timed, {r['wall_s']:.3f}s wall, "
                  f"{r['mlups']:.1f} MLUPS, {r['speedup']:.1f}x vs K20m; diff "
                  f"{r['max_diff_pct']:.4f}%; Re {r['reynolds']:.6f} | {name}")
    for r in rows:
        if r["golden"] is None:
            print(f"NOTE {r['case']}: no golden covers {r['iters']} steps; drift not "
                  "gated (finiteness only)")
    failed = []
    for r in rows:
        if r["golden"] is not None and not r["max_diff_pct"] <= args.tolerance:
            failed.append(f"{r['case']} ({r['max_diff_pct']:.4f}%)")
        elif not r["av_finite"]:
            failed.append(f"{r['case']} (non-finite av_vels)")
        elif not np.isfinite(r["reynolds"]):
            failed.append(f"{r['case']} (non-finite Reynolds)")
    if failed:
        print(f"FAILED tolerance {args.tolerance}%: {', '.join(failed)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

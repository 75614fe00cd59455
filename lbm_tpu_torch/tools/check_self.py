"""The port's self-contained gate (the counterpart of the ``Makefile``'s
``check-self`` rules, which run ``lbm_tpu.cli``).

For each case: write its inputs (:mod:`gen_inputs`), run them through the
port's CLI (``lbm_tpu_torch.cli run``), and check the outputs against the
vendored fp64 goldens in ``tests/goldens/`` with the checker at 1%:
av_vels always (cut to the steps run), final_state where the case has a
golden of it (128x128, 128x256, 256x256) and the run is full length.
Prints one line per case and exits non-zero if any case fails.  Needs no
reference checkout.

Usage (from the repository root; on the card unless ``LBM_DEVICE=cpu``)::

    python -m lbm_tpu_torch.tools.check_self
    LBM_DEVICE=cpu python -m lbm_tpu_torch.tools.check_self --case 128x128 --max-iters 200
"""

from __future__ import annotations

import argparse
import contextlib
import io
import pathlib
import re
import sys
import time

from lbm_tpu_torch import _native, cli
from lbm_tpu_torch.checker import check_files
from lbm_tpu_torch.config import CANONICAL_PARAMS
from lbm_tpu_torch.tools.gen_inputs import write_case

ROOT = pathlib.Path(__file__).resolve().parents[2]
GOLDENS = ROOT / "tests" / "goldens"


def golden_av_prefix(case: str, steps: int, out: pathlib.Path) -> pathlib.Path:
    """The vendored golden av_vels cut to its first ``steps`` lines, written
    to ``out`` (a run of N steps makes the first N lines of a longer run)."""
    lines = (GOLDENS / f"{case}.fp64gen_av_vels.dat").read_text().splitlines()
    if len(lines) < steps:
        raise ValueError(f"{case}: the golden holds {len(lines)} steps, fewer than {steps}")
    out.write_text("".join(line + "\n" for line in lines[:steps]))
    return out


def check_case(case: str, workdir: pathlib.Path, max_iters: int | None = None) -> dict:
    """Run ``case`` through the CLI in ``workdir/<case>`` and check it; the
    CLI's and the checker's output go to ``cli.log`` and ``check.log``
    there."""
    full = CANONICAL_PARAMS[case].max_iters
    steps = full if max_iters is None else max_iters
    d = workdir / case
    params_path, obstacles_path = write_case(case, d, max_iters)
    calls = dict(_native.CALLS)
    out = io.StringIO()
    tic = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["run", str(params_path), str(obstacles_path), "--output-dir", str(d)])
    wall = time.perf_counter() - tic
    (d / "cli.log").write_text(out.getvalue())
    native = all(_native.CALLS[k] > calls[k] for k in calls)
    fs_golden = GOLDENS / f"{case}.fp64gen_final_state.dat"
    with_fs = steps == full and fs_golden.exists()
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        res = check_files(
            ref_av_vels=str(golden_av_prefix(case, steps, d / "golden_av_vels.dat")),
            ref_final_state=str(fs_golden) if with_fs else None,
            av_vels=str(d / "av_vels.dat"),
            final_state=str(d / "final_state.dat") if with_fs else None,
        )
    (d / "check.log").write_text(report.getvalue())
    elapsed = re.search(r"Elapsed time:\s+([0-9.]+)", out.getvalue())
    return {"case": case, "steps": steps, "ok": rc == 0 and res.ok, "rc": rc,
            "elapsed_s": float(elapsed.group(1)) if elapsed else float("nan"),
            "wall_s": wall, "native_io": native, "final_state_checked": with_fs,
            "worst_pct": {k: abs(v) for k, v in res.worst_pct.items()}}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--case", action="append", choices=sorted(CANONICAL_PARAMS),
                        help="a case to check (repeatable; default all four)")
    parser.add_argument("--max-iters", type=int, default=None,
                        help="run a prefix of each case (av_vels only)")
    parser.add_argument("--workdir", type=pathlib.Path,
                        default=ROOT / "build" / "check_self",
                        help="where the inputs and outputs are written")
    args = parser.parse_args(argv)
    failed = []
    for case in args.case or list(CANONICAL_PARAMS):
        r = check_case(case, args.workdir, args.max_iters)
        worst = ", ".join(f"{k} {v:.4f}%" for k, v in r["worst_pct"].items()) or "none"
        print(f"{'PASS' if r['ok'] else 'FAIL'} {case}: {r['steps']} steps, "
              f"{r['elapsed_s']:.6f} s timed, {r['wall_s']:.3f} s wall; worst deviation "
              f"{worst}; final_state {'checked' if r['final_state_checked'] else 'not checked'}; "
              f"native I/O {'yes' if r['native_io'] else 'no'}", flush=True)
        if not r["ok"]:
            failed.append(case)
    if failed:
        print(f"FAILED: {', '.join(failed)} (logs under {args.workdir})")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

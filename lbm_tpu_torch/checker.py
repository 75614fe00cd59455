"""Output checker core — the reference protocol at 1% relative tolerance.

Contract (matching the reference's ``check/check.py`` and
``lbm_tpu.checker``): compare a simulated ``av_vels.dat`` (column 1) and
``final_state.dat`` (columns 0, 1, 5 = x, y, pressure) against reference
files; coordinates must match exactly, step counts must match, and the run
passes iff the maximum per-element relative difference on both series is
finite and below the tolerance (default 1%).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from lbm_tpu_torch.io import read_av_vels


@dataclasses.dataclass(frozen=True)
class CheckResult:
    """Verdict plus the worst signed percent deviation of each series
    (NaN when a series was not finite; empty when the files were
    structurally incompatible)."""

    ok: bool
    worst_pct: dict[str, float]


def _load(av_vels_path: str, final_state_path: str | None):
    av = read_av_vels(av_vels_path)
    if final_state_path is None:
        return av, None
    # Only the checker-relevant columns (x, y, pressure).
    fs = np.loadtxt(final_state_path, usecols=[0, 1, 5], ndmin=2)
    return av, fs


def _report(name: str, ref: np.ndarray, sim: np.ndarray, where) -> float:
    if ref.size == 0:
        print(f"Total difference in {name} : 0 (empty series)")
        print()
        return 0.0
    diff = ref - sim
    with np.errstate(divide="ignore", invalid="ignore"):
        pct = 100.0 * diff / sim
    # Reference protocol: plain argmax, which lands on a NaN entry if one
    # exists, so a non-finite percent-diff anywhere fails the check.
    idx = int(np.argmax(np.abs(pct)))
    print(f"Total difference in {name} : {np.abs(diff).sum():.12E}")
    print(f"Biggest difference (at {where(idx)}) : {diff[idx]:.12E}")
    print(f"  {sim[idx]:.12E} vs. {ref[idx]:.12E} = {pct[idx]:.2g}%")
    print()
    return float(pct[idx]) if np.isfinite(pct[idx]) else float("nan")


def check_files(
    *,
    ref_av_vels: str,
    ref_final_state: str | None = None,
    av_vels: str,
    final_state: str | None = None,
    tolerance: float = 1.0,
) -> CheckResult:
    """Run the full comparison; prints the report.

    When no reference final_state is given only the av_vels series is
    checked (the upstream goldens for 256x256/1024x1024 carry av_vels only).
    """
    if (ref_final_state is None) != (final_state is None):
        missing = (
            "--ref-final-state-file" if ref_final_state is None
            else "--final-state-file"
        )
        print(f"final_state comparison requested but {missing} is missing")
        return CheckResult(False, {})
    av_ref, fs_ref = _load(ref_av_vels, ref_final_state)
    av_sim, fs_sim = _load(av_vels, final_state)

    if fs_ref is not None:
        if fs_ref.shape != fs_sim.shape or (fs_ref[:, :2] != fs_sim[:, :2]).any():
            print("Final state files coordinates were not the same")
            return CheckResult(False, {})
    if av_ref.size != av_sim.size:
        print("Different number of steps in av_vels files")
        return CheckResult(False, {})

    checks = {"av_vels": _report("av_vels", av_ref, av_sim, lambda i: f"step {i}")}
    if fs_ref is not None:
        checks["final state"] = _report(
            "final_state",
            fs_ref[:, 2],
            fs_sim[:, 2],
            lambda i: f"coord ({int(fs_sim[i, 0])},{int(fs_sim[i, 1])})",
        )
    else:
        print("(no reference final_state; av_vels-only check)")

    failed = False
    for name, worst in checks.items():
        if not np.isfinite(worst) or abs(worst) > tolerance:
            print(f"{name} failed check")
            failed = True
    if not failed:
        print("Both tests passed!" if fs_ref is not None else "av_vels passed!")
    return CheckResult(not failed, checks)


def compare_files(**kwargs) -> bool:
    """:func:`check_files`, verdict only (``lbm_tpu.checker``'s signature)."""
    return check_files(**kwargs).ok


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Validate LBM outputs against reference results",
        fromfile_prefix_chars="@",
    )
    parser.add_argument("--tolerance", nargs=1, default=[1.0], type=float)
    parser.add_argument("--ref-av-vels-file", nargs=1, required=True)
    parser.add_argument("--ref-final-state-file", nargs=1, default=[None])
    parser.add_argument("--av-vels-file", nargs=1, required=True)
    parser.add_argument("--final-state-file", nargs=1, default=[None])
    args = parser.parse_args(argv)
    ok = compare_files(
        ref_av_vels=args.ref_av_vels_file[0],
        ref_final_state=args.ref_final_state_file[0],
        av_vels=args.av_vels_file[0],
        final_state=args.final_state_file[0],
        tolerance=args.tolerance[0],
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

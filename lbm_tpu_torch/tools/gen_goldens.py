"""Generate golden files with the float64 engine (the port of
``tools/gen_goldens.py``).

Runs :func:`lbm_tpu_torch.validation.run64` for a canonical case and writes
``<case>.fp64gen_av_vels.dat`` and, at the case's full length,
``<case>.fp64gen_final_state.dat``, with the port's writers, in the
formats of ``tests/goldens/``.

It never overwrites a file: it writes only the files of a case that the
output directory does not hold yet, and exits non-zero where it holds all
of them.  Before anything is written, the run's av series is held against
the vendored ``tests/goldens/<case>.fp64gen_av_vels.dat`` (made by
``lbm_tpu``'s numpy engine), every line within 1e-12 relative; the lines
whose text differs are counted.  Each file goes to a temporary name first
and is renamed only after that check.

Usage (from the repository root; on the card unless ``LBM_DEVICE=cpu``)::

    python -m lbm_tpu_torch.tools.gen_goldens --case 256x256
    python -m lbm_tpu_torch.tools.gen_goldens --case 128x128 --outdir out --max-iters 500
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np
import torch

from lbm_tpu_torch.config import CANONICAL_PARAMS
from lbm_tpu_torch.geometry import canonical_obstacles
from lbm_tpu_torch.io import write_av_vels, write_final_state
from lbm_tpu_torch.validation import run64

GOLDENS = pathlib.Path(__file__).resolve().parents[2] / "tests" / "goldens"
AV_RTOL = 1e-12


def hold_av(case: str, av: np.ndarray, scratch: pathlib.Path) -> dict:
    """The run's av series against the vendored one's first ``len(av)``
    lines: the largest relative difference, and the lines whose text
    differs (the series written to ``scratch`` by the port's writer)."""
    vendored = GOLDENS / f"{case}.fp64gen_av_vels.dat"
    lines = vendored.read_text().splitlines()
    if len(lines) < len(av):
        raise ValueError(f"{vendored} holds {len(lines)} steps, fewer than {len(av)}")
    ref = np.array([float(line.split()[1]) for line in lines[:len(av)]])
    write_av_vels(scratch, av)
    ours = scratch.read_text().splitlines()
    rel = np.abs(av - ref) / np.abs(ref)
    return {"steps": len(av), "max_rel": float(rel.max(initial=0.0)),
            "text_differs": sum(a != b for a, b in zip(ours, lines)),
            "ok": bool((rel <= AV_RTOL).all())}


def generate(case: str, outdir: pathlib.Path, max_iters: int | None = None,
             device=None) -> dict:
    """Run ``case`` in float64 and write its missing golden files to
    ``outdir``; raises ``FileExistsError`` where none is missing and
    ``ValueError`` where the av series fails the vendored one."""
    params = CANONICAL_PARAMS[case]
    steps = params.max_iters if max_iters is None else max_iters
    names = [f"{case}.fp64gen_av_vels.dat"]
    if steps == params.max_iters:  # final_state is the end state
        names.append(f"{case}.fp64gen_final_state.dat")
    missing = [n for n in names if not (outdir / n).exists()]
    if not missing:
        raise FileExistsError(f"{outdir} already holds {', '.join(names)}: "
                              "golden files are never overwritten")
    obstacles = canonical_obstacles(case)
    tic = time.perf_counter()
    f, av = run64(params, obstacles, max_iters=steps, device=device)
    dev, f = f.device, f.cpu().numpy()
    seconds = time.perf_counter() - tic
    outdir.mkdir(parents=True, exist_ok=True)
    tmps = {n: outdir / f"{n}.tmp" for n in missing}
    try:
        held = hold_av(case, av, outdir / f"{case}.av_check.tmp")
        if not held["ok"]:
            raise ValueError(f"{case}: the fp64 av series is {held['max_rel']:.3e} "
                             f"relative from the vendored one (allowed {AV_RTOL:g}): "
                             "refusing to write")
        for name, tmp in tmps.items():
            if name.endswith("av_vels.dat"):
                write_av_vels(tmp, av)
            else:
                write_final_state(tmp, params, f, obstacles)
        for name, tmp in tmps.items():
            tmp.replace(outdir / name)
    finally:
        for tmp in [*tmps.values(), outdir / f"{case}.av_check.tmp"]:
            tmp.unlink(missing_ok=True)
    device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"case": case, "steps": steps, "seconds": seconds, "device": device_name,
            "written": missing, **{f"av_{k}": v for k, v in held.items()}}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--case", action="append", required=True,
                        choices=sorted(CANONICAL_PARAMS))
    parser.add_argument("--outdir", type=pathlib.Path, default=GOLDENS)
    parser.add_argument("--max-iters", type=int, default=None,
                        help="a prefix of the case (writes av_vels only)")
    args = parser.parse_args(argv)
    rc = 0
    for case in args.case:
        try:
            r = generate(case, args.outdir, args.max_iters)
        except (FileExistsError, ValueError) as e:
            print(f"FAIL {case}: {e}")
            rc = 1
            continue
        print(f"{case}: {r['steps']} fp64 steps in {r['seconds']:.3f} s on {r['device']}; "
              f"av against the vendored series: max rel {r['av_max_rel']:.3e}, "
              f"{r['av_text_differs']} of {r['steps']} lines differ in text; wrote "
              f"{', '.join(r['written'])} to {args.outdir}")
    return rc


if __name__ == "__main__":
    sys.exit(main())

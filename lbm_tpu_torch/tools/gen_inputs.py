"""Generate the input files of a case (the port of ``tools/gen_inputs.py``,
with its command line and its bytes).

The four canonical cases are a parameterised geometry family
(:mod:`lbm_tpu_torch.geometry`); this writes ``input_<name>.params`` and
``obstacles_<name>.dat`` for any of them, or for a channel box of any size.

Usage::

    python -m lbm_tpu_torch.tools.gen_inputs 128x128 outdir/
    python -m lbm_tpu_torch.tools.gen_inputs 256x256 outdir/ --max-iters 1000
    python -m lbm_tpu_torch.tools.gen_inputs --nx 512 --ny 512 --max-iters 1000 outdir/
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

import numpy as np

from lbm_tpu_torch.config import CANONICAL_PARAMS, LBMParams
from lbm_tpu_torch.geometry import canonical_obstacles, channel_box, write_obstacle_file


def write_inputs(name: str, params: LBMParams, mask: np.ndarray,
                 outdir: pathlib.Path) -> tuple[pathlib.Path, pathlib.Path]:
    """``input_<name>.params`` and ``obstacles_<name>.dat`` in ``outdir``."""
    outdir.mkdir(parents=True, exist_ok=True)
    paths = outdir / f"input_{name}.params", outdir / f"obstacles_{name}.dat"
    params.to_file(paths[0])
    write_obstacle_file(paths[1], mask)
    return paths


def write_case(case: str, outdir: pathlib.Path,
               max_iters: int | None = None) -> tuple[pathlib.Path, pathlib.Path]:
    """The input files of canonical ``case`` (``max_iters`` in place of its
    own where given)."""
    params = CANONICAL_PARAMS[case]
    if max_iters is not None:
        params = dataclasses.replace(params, max_iters=max_iters)
    return write_inputs(case, params, canonical_obstacles(case), outdir)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("case", nargs="?", help="canonical case name, e.g. 128x128")
    parser.add_argument("outdir", type=pathlib.Path)
    parser.add_argument("--nx", type=int)
    parser.add_argument("--ny", type=int)
    parser.add_argument("--max-iters", type=int, default=None,
                        help="override max_iters (canonical cases keep their own; "
                             "custom grids default to 1000)")
    parser.add_argument("--density", type=float, default=0.1)
    parser.add_argument("--accel", type=float, default=0.005)
    parser.add_argument("--omega", type=float, default=1.85)
    parser.add_argument("--reynolds-dim", type=int, default=10)
    args = parser.parse_args(argv)

    if args.case:
        name = args.case
        write_case(name, args.outdir, args.max_iters)
    else:
        if not (args.nx and args.ny):
            parser.error("need a canonical case name or --nx/--ny")
        name = f"{args.nx}x{args.ny}"
        params = LBMParams(args.nx, args.ny,
                           args.max_iters if args.max_iters is not None else 1000,
                           args.reynolds_dim, args.density, args.accel, args.omega)
        write_inputs(name, params, channel_box(args.nx, args.ny), args.outdir)
    print(f"wrote input_{name}.params and obstacles_{name}.dat to {args.outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings that the limits of ``checks/<cell>.json`` are set from.
The benchmark's own runs never run this.

    python benchmark/calibrate.py --workload c256.solve --seeds 1-12 --mode sound
    python benchmark/calibrate.py --workload c256.solve --seeds 1-3 --mode control

``sound``: the program's answer to each seed's first job of the window, at
the cell's own size and through the window's own entry, against the plain
reference: the numbers of ``lbmbench.compare``, one JSON line a seed.
``control``: the plain reference in bfloat16, the precision below the
configuration's float32, put in the program's place, against the same
reference in float32 (it diverges at the cells' sizes: a control that
gives no number fails and sets no upper end).  ``program16``: the
program's own 16-bit storage path (``TemporalStep(storage=float16 |
bfloat16)``, at the tile the program chooses for the grid) in the
program's place, from the same state and obstacles.  Each mode prints one
JSON line a seed.
"""

import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lbmbench import cases, compare, harness, spec, traffic  # noqa: E402


def seeds_of(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def program16(t, port, f0: torch.Tensor, storage: torch.dtype) -> tuple:
    """The program's own 16-bit storage path (``TemporalStep(storage=)``, at
    the tile the program chooses for the grid) from ``f0`` over the
    configuration's steps, on the traffic's obstacles: ``(av, fields)``."""
    from lbm_tpu_torch.ops import schedule
    from lbm_tpu_torch.ops.fused import TemporalStep

    p = t.params
    params = port.config.LBMParams(p["nx"], p["ny"], p["maxIters"], p["reynolds_dim"],
                                   p["density"], p["accel"], p["omega"])
    fcinv = np.float32(1.0) / np.float32(int((~t.obstacles).sum()))
    by, bx, k = schedule.choose_temporal(p["ny"], p["nx"], p["maxIters"])
    prog = TemporalStep(params, t.obstacles, fcinv, t.device, by, bx, k, storage=storage)
    fa = f0.to(storage).contiguous()
    fb = torch.empty_like(fa)
    av = torch.empty(p["maxIters"], dtype=torch.float32, device=t.device)
    launch = prog.bind(fa, fb, av)
    launches = p["maxIters"] // k
    for i in range(launches):
        launch(i)
    final = (fa, fb)[prog.final_index(launches)].float()
    fields = spec.load_module(t.cell.reference).fields(final, t.obstacles, p["density"])
    return av.cpu().numpy(), fields


def control_numbers(t, ref: tuple, low: tuple) -> dict:
    """The numbers of a lower-precision answer ``(av, fields)`` in the
    program's place, against the float32 reference's ``(av, fields)``."""
    return compare.solve_numbers([low], [ref], t.params["density"])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="e.g. 1-12 or 5,9,40")
    parser.add_argument("--mode", choices=("sound", "control", "program16"), required=True)
    args = parser.parse_args(argv)
    root = HERE.parent
    cell = spec.Spec.load(root).cell(args.workload)
    if not torch.cuda.is_available():
        print("calibration reads the card; no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    port = harness.import_port(root)
    work = root / ".bench_work" / f"{cell.name}.calibrate"
    entry = cell.traffic["entry"]
    solve = None
    for seed in seeds_of(args.seeds):
        tic = time.perf_counter()
        if entry == "solve":
            if solve is None:
                solve = traffic.make(cell, port, seed, device, work)
                solve.setup()
            t = solve
            t.seed = seed
            f0 = t.state(0)
        else:
            t = traffic.make(cell, port, seed, device, work)
            t.obstacles = cases.obstacles(t.config, t.traffic, seed)
            f0 = cases.initial_state(t.config, {"amplitude": 0.0}, seed, 0, device)
        if args.mode == "sound" and entry == "solve":
            numbers = t.check([t.job(0)])
        elif args.mode == "sound":
            t.setup()  # writes the seed's files and runs the CLI once
            t.stdout_path.write_text("")
            numbers = t.check([t.job(0)])
        else:
            ref_fields, ref_av = t.reference(f0[None], torch.float32, t.obstacles)
            ref = (ref_av[0], ref_fields[0])
            if args.mode == "control":
                low_fields, low_av = t.reference(f0[None], torch.bfloat16, t.obstacles)
                numbers = control_numbers(t, ref, (low_av[0], low_fields[0]))
            else:
                numbers = {str(s).split(".")[-1]: control_numbers(t, ref, program16(t, port, f0, s))
                           for s in (torch.float16, torch.bfloat16)}
        print(json.dumps({"workload": cell.name, "mode": args.mode, "seed": seed,
                          "numbers": numbers, "seconds": time.perf_counter() - tic}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

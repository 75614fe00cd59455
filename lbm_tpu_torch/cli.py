"""Command-line interface of the port (``run``, ``bench``, ``check``,
``autotune``).

Parity target: the reference binary's contract (``d2q9-bgk.c:876-880``):
``<paramfile> <obstaclefile>`` in, the 4-line epilogue (``==done==``,
Reynolds number, elapsed and CPU times, ``d2q9-bgk.c:271-275``) on stdout,
``final_state.dat`` and ``av_vels.dat`` out.  The device comes from
``--device`` or ``LBM_DEVICE`` (a CUDA index, or ``cpu``).

``--shards N`` and ``--mesh PYxPX`` run the grid sharded over a row or a
2-D mesh (``lbm_tpu_torch.parallel.sharded``), on the visible CUDA devices
round-robin (every shard on one card where there is one), with an
optional ``--temporal-split BYxK`` (the shard temporal kernel) or
``BYxKxPX`` (the shard x-tiled kernel on row slabs).  ``autotune``
measures the temporal kernels' tiles on the card and records the ranked
winners in the tuning cache, which the chooser reads first
(:mod:`lbm_tpu_torch.tuning`).

    python -m lbm_tpu_torch.cli run input.params obstacles.dat --output-dir out
    python -m lbm_tpu_torch.cli run ... --checkpoint-dir ckpt   # resumable
    python -m lbm_tpu_torch.cli run ... --kernel mega
    python -m lbm_tpu_torch.cli run ... --profile prof           # prof/trace.json, with spans
    python -m lbm_tpu_torch.cli run ... --shards 8              # or --mesh 4x2
    python -m lbm_tpu_torch.cli run ... --shards 4 --temporal-split 32x4x2
    python -m lbm_tpu_torch.cli bench            # 1024x1024 x 20000, JSON line
    python -m lbm_tpu_torch.cli check --ref-av-vels-file ... --av-vels-file ...
    python -m lbm_tpu_torch.cli autotune --case 1024x1024 [--refresh] [--dry-run]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import resource
import sys

import torch

from lbm_tpu_torch.config import CANONICAL_PARAMS, LBMParams
from lbm_tpu_torch.geometry import canonical_obstacles, channel_box, load_obstacle_file
from lbm_tpu_torch.io import write_av_vels, write_final_state
from lbm_tpu_torch.runtime import Simulator, select_device
from lbm_tpu_torch.utils.profiling import PerfReport, span, trace


def _load_case(params_path: str, obstacles_path: str):
    with span("cli.parse"):
        params = LBMParams.from_file(params_path)
        obstacles, _ = load_obstacle_file(obstacles_path, params.nx, params.ny)
        return params, obstacles


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _epilogue(res) -> None:
    """The reference's stdout contract plus MLUPS and bandwidth."""
    usage = resource.getrusage(resource.RUSAGE_SELF)
    print("==done==")
    print(f"Reynolds number:\t\t{res.reynolds:.12E}")
    print(f"Elapsed time:\t\t\t{res.elapsed:.6f} (s)")
    print(f"Elapsed user CPU time:\t\t{usage.ru_utime:.6f} (s)")
    print(f"Elapsed system CPU time:\t{usage.ru_stime:.6f} (s)")
    report = PerfReport(
        nx=res.params.nx, ny=res.params.ny, steps=res.steps_timed,
        elapsed=res.elapsed, bytes_per_update=res.bytes_per_update,
    )
    print(f"MLUPS:\t\t\t\t{report.mlups:.1f}")
    print(f"Effective bandwidth:\t\t{report.effective_bandwidth_gbs:.1f} GB/s")


def _parse_pair(value: str, flag: str) -> tuple[int, int]:
    """Parse an ``AxB`` flag value into two positive ints."""
    try:
        a, b = (int(v) for v in value.lower().split("x"))
    except ValueError:
        raise SystemExit(f"{flag} must be AxB (e.g. 2x4), got {value!r}")
    if a < 1 or b < 1:
        raise SystemExit(f"{flag} values must be positive, got {value!r}")
    return a, b


def cmd_run(args: argparse.Namespace) -> int:
    """``run``: one CLI call, the span ``cli.run`` (with ``--profile DIR``,
    all of it profiled into ``DIR/trace.json``)."""
    profile = trace(args.profile) if args.profile else contextlib.nullcontext()
    with profile, span("cli.run"):
        return _run_case(args)


def _run_case(args: argparse.Namespace) -> int:
    params, obstacles = _load_case(args.paramfile, args.obstaclefile)
    if args.max_iters is not None:
        params = dataclasses.replace(params, max_iters=args.max_iters)
    if args.mesh is not None and args.shards != 1:
        raise SystemExit("give either --shards N (1-D mesh) or --mesh "
                         "PYxPX (2-D mesh), not both")
    if args.shards < 1:
        raise SystemExit(f"--shards must be positive, got {args.shards}")
    if args.mesh is not None or args.shards > 1:
        # Flags the sharded path doesn't implement must fail loudly rather
        # than be silently ignored.
        if args.device is not None:
            raise SystemExit("--device cannot be combined with "
                             "--shards/--mesh (the mesh spans devices)")
        if args.kernel == "mega":
            raise SystemExit("--kernel mega is single-chip only; use "
                             "fused/temporal with --shards/--mesh")
        with span("cli.setup"):
            sim = _sharded_simulator(args, params, obstacles)
        return _run_and_write(args, sim)
    if args.temporal_split is not None:
        raise SystemExit("--temporal-split applies to the sharded paths "
                         "(--shards/--mesh)")
    with span("cli.setup"):
        device = select_device(args.device)
        # Device inventory and selection, like the reference's startup stdout
        # (``d2q9-bgk.c:911-918``, 941).
        print("Available devices:")
        for i in range(torch.cuda.device_count()):
            print(f"  {i}: {torch.cuda.get_device_name(i)} (cuda)")
        print(f"Selected device {device}: {_device_name(device)}")
        # Builds the kernel outside the timed region (like clBuildProgram).
        sim = Simulator(params, obstacles, kernel=args.kernel, device=device)
        if not args.checkpoint_dir:
            prog = sim.program
            tile = (f", tile {prog.by}x{prog.bx}, K {getattr(prog, 'ksteps', prog.chunk)}"
                    if hasattr(prog, "bx") else "")
            print(f"Kernel program: {type(prog).__name__} (steps/launch {prog.chunk}{tile}); "
                  f"launches: {sim.launch_route()}")
    return _run_and_write(args, sim)


def _sharded_simulator(args, params, obstacles):
    """The sharded run of ``--shards N`` (a row mesh) or ``--mesh PYxPX``
    (rows x cols), with an optional ``--temporal-split BYxK`` or ``BYxKxPX``
    (``lbm_tpu``'s parse, checks and messages): the
    ``BASELINE.json`` weak-scaling configuration from this one command, as
    ``lbm_tpu``'s ``_run_sharded``."""
    from lbm_tpu_torch.parallel.mesh import default_mesh, default_mesh_2d
    from lbm_tpu_torch.parallel.sharded import ShardedSimulator

    split = None
    if args.temporal_split is not None:
        parts = args.temporal_split.lower().split("x")
        if len(parts) == 3:
            # BYxKxPX: the x-tiled route, PX column strips per shard.
            try:
                split = tuple(int(v) for v in parts)
            except ValueError:
                split = (0,)
            if len(split) != 3 or any(v < 1 for v in split):
                raise SystemExit("--temporal-split must be BYxK or BYxKxPX (e.g. "
                                 f"128x4x4), got {args.temporal_split!r}")
        elif len(parts) == 2:
            split = _parse_pair(args.temporal_split, "--temporal-split")
        else:
            raise SystemExit("--temporal-split must be BYxK or BYxKxPX (e.g. 128x4 or "
                             f"128x4x4), got {args.temporal_split!r}")
        if args.kernel == "reference":
            raise SystemExit("--temporal-split requires a CUDA kernel "
                             "(--kernel temporal/fused), not 'reference'")
        if args.kernel == "auto":
            args.kernel = "temporal"
    if args.mesh is not None:
        mesh = default_mesh_2d(*_parse_pair(args.mesh, "--mesh"))
    else:
        mesh = default_mesh(args.shards)
    print(f"Mesh: {mesh.describe()}")
    if mesh.device(0, 0).type == "cpu":
        print("NOTE: LBM_DEVICE=cpu: the shards run their plain torch versions "
              "(correctness only, not performance)")
    sim = ShardedSimulator(params, obstacles, mesh=mesh, kernel=args.kernel,
                           temporal_split=split)
    if not args.checkpoint_dir:
        print(f"Kernel variant: {sim.variant()} (steps/pass {sim.chunk()}); "
              f"launches: {sim.launch_route()}")
    return sim


def _run_and_write(args, sim) -> int:
    """The run tail shared by the single-device and sharded paths:
    execute (checkpointed or not), print the epilogue, write the output
    files."""
    if args.checkpoint_dir:
        # Snapshots hold f, so the run ends with f on the host.
        res = sim.run_checkpointed(args.checkpoint_dir, every=args.checkpoint_every)
    else:
        # The outputs need only the derived planes: fetch those, not f.
        res = sim.run(readback="fields")
    with span("cli.epilogue"):
        _epilogue(res)
    outdir = pathlib.Path(args.output_dir)
    outdir.mkdir(parents=True, exist_ok=True)
    write_final_state(
        outdir / "final_state.dat", res.params, res.f, res.obstacles,
        fields=res.fields,
    )
    write_av_vels(outdir / "av_vels.dat", res.av_vels)
    return 0


def cmd_bench(args: argparse.Namespace) -> int:
    if args.repeats < 1:
        raise SystemExit(f"--repeats must be >= 1, got {args.repeats}")
    if (args.paramfile is None) != (args.obstaclefile is None):
        raise SystemExit("give both paramfile and obstaclefile, or neither")
    if args.paramfile is None:
        params = CANONICAL_PARAMS["1024x1024"]
        obstacles = canonical_obstacles("1024x1024")
    else:
        params, obstacles = _load_case(args.paramfile, args.obstaclefile)
    if args.max_iters is not None:
        params = dataclasses.replace(params, max_iters=args.max_iters)
    device = select_device(args.device)
    sim = Simulator(params, obstacles, kernel=args.kernel, device=device)
    best = None
    for _ in range(args.repeats):
        res = sim.run(readback="fields")
        best = res if best is None or res.elapsed < best.elapsed else best
    print(
        json.dumps(
            {
                "metric": f"MLUPS {params.nx}x{params.ny}",
                "value": round(best.mlups, 1),
                "unit": "MLUPS",
                "steps": params.max_iters,
                "elapsed_s": round(best.elapsed, 4),
                "reynolds": best.reynolds,
                "kernel": args.kernel,
                "device": _device_name(device),
            }
        )
    )
    return 0


def cmd_check(args: argparse.Namespace) -> int:
    from lbm_tpu_torch.checker import compare_files

    ok = compare_files(
        ref_av_vels=args.ref_av_vels_file,
        ref_final_state=args.ref_final_state_file,
        av_vels=args.av_vels_file,
        final_state=args.final_state_file,
        tolerance=args.tolerance,
    )
    return 0 if ok else 1


def cmd_autotune(args: argparse.Namespace) -> int:
    """Measure the temporal kernels' (BY, BX, K) candidates on the card and
    record the winners in the tuning cache (the automatic analog of the
    reference's per-grid workgroup tuning)."""
    from lbm_tpu_torch.tuning import autotune_sweep, refresh_incumbents

    if bool(args.case) == bool(args.grid):
        raise SystemExit("give exactly one of --case / --grid")
    if args.steps < 1:
        raise SystemExit(f"--steps must be >= 1, got {args.steps}")
    if args.repeats < 1:
        raise SystemExit(f"--repeats must be >= 1, got {args.repeats}")
    if args.case:
        params = CANONICAL_PARAMS[args.case]
        obstacles = canonical_obstacles(args.case)
    else:
        ny, nx = _parse_pair(args.grid, "--grid")
        params = LBMParams(nx, ny, args.steps, 10, 0.1, 0.005, 1.85)
        obstacles = channel_box(nx, ny)
    params = dataclasses.replace(params, max_iters=args.steps)
    kwargs = dict(steps=args.steps, repeats=args.repeats,
                  record_results=not args.dry_run)

    results = []
    if args.refresh:
        # Stale-cache guard (tuning.py docstring): re-time only the
        # recorded incumbents and warn on ranking/timing drift; fall back
        # to the full sweep when the cache has nothing for this shape.
        results = refresh_incumbents(params, obstacles, **kwargs)
        if not results:
            print("falling back to a full sweep", flush=True)
    if not results:
        results = autotune_sweep(params, obstacles, **kwargs)
    if not results:
        print("no candidate compiled and ran")
        return 1
    by, bx, k, us, schedule = results[0]
    glups = params.ny * params.nx / us / 1e3
    tag = ", x-tiled" if schedule == "xtiled" else ""
    print(f"best: (BY={by}, BX={bx}, K={k}{tag}) at {us:.2f} us/step = {glups:.1f} GLUPS")
    print(json.dumps({"ny": params.ny, "nx": params.nx, "by": by, "bx": bx, "k": k,
                      "schedule": schedule, "us_per_step": round(us, 2)}))
    return 0


def cmd_autotune_main(argv: list[str] | None = None) -> int:
    """Entry point of ``lbm_tpu_torch.tools.autotune``: parse only the
    autotune flags and run the sweep."""
    parser = argparse.ArgumentParser(description=cmd_autotune.__doc__)
    _add_autotune_args(parser)
    return cmd_autotune(parser.parse_args(argv))


def _add_autotune_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--case", choices=sorted(CANONICAL_PARAMS))
    parser.add_argument("--grid", help="NYxNX for a non-canonical grid")
    parser.add_argument("--steps", type=int, default=960,
                        help="timed loop length (divisible by 16 keeps every K "
                             "candidate eligible)")
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--dry-run", action="store_true",
                        help="measure and print but do not write the cache")
    parser.add_argument("--refresh", action="store_true",
                        help="re-time only the recorded incumbents and warn if the "
                             "ranking or the winner's timing drifted — the stale-cache "
                             "check after a kernel change; falls back to a full sweep "
                             "when the cache has no entry for this shape")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="lbm-torch",
        description="D2Q9-BGK lattice-Boltzmann solver (PyTorch + CUDA)",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    kernels = ["auto", "fused", "temporal", "mega", "reference"]

    run = sub.add_parser("run", help="simulate and write output files")
    run.add_argument("paramfile")
    run.add_argument("obstaclefile")
    run.add_argument("--output-dir", default=".")
    run.add_argument("--kernel", default="auto", choices=kernels)
    run.add_argument("--device", default=None,
                     help="CUDA index or 'cpu' (LBM_DEVICE analog)")
    run.add_argument("--max-iters", type=int, default=None)
    run.add_argument("--profile", default=None, metavar="TRACE_DIR",
                     help="write a torch.profiler Chrome trace of the run to "
                          "TRACE_DIR/trace.json; it holds the program's spans "
                          "(cli.*, runtime.*, graphs.*, io.*) beside the device's "
                          "operations")
    run.add_argument("--checkpoint-dir", default=None,
                     help="snapshot resumable state here (and resume from it)")
    run.add_argument("--checkpoint-every", type=int, default=10000, metavar="STEPS")
    run.add_argument("--shards", type=int, default=1,
                     help="row-shard over N shards (1-D mesh)")
    run.add_argument("--mesh", default=None, metavar="PYxPX",
                     help="shard over a PYxPX (rows x cols) mesh; exclusive with "
                     "--shards")
    run.add_argument("--temporal-split", default=None, metavar="BYxK[xPX]",
                     help="explicit temporal (BY, K) of the sharded paths, or "
                          "(BY, K, PX) for the x-tiled route")
    run.set_defaults(func=cmd_run)

    bench = sub.add_parser(
        "bench", help="timed run (default 1024x1024 x 20000), JSON metric line"
    )
    bench.add_argument("paramfile", nargs="?")
    bench.add_argument("obstaclefile", nargs="?")
    bench.add_argument("--kernel", default="auto", choices=kernels)
    bench.add_argument("--device", default=None)
    bench.add_argument("--max-iters", type=int, default=None)
    bench.add_argument("--repeats", type=int, default=3)
    bench.set_defaults(func=cmd_bench)

    check = sub.add_parser("check", help="compare outputs against references")
    check.add_argument("--tolerance", type=float, default=1.0)
    check.add_argument("--ref-av-vels-file", required=True)
    check.add_argument("--ref-final-state-file", default=None)
    check.add_argument("--av-vels-file", required=True)
    check.add_argument("--final-state-file", default=None)
    check.set_defaults(func=cmd_check)

    autotune = sub.add_parser(
        "autotune", help="measure temporal (BY, BX, K) candidates, record the winners"
    )
    _add_autotune_args(autotune)
    autotune.set_defaults(func=cmd_autotune)
    return parser


_COMMANDS = ("run", "bench", "check", "autotune")


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    # Reference invocation contract: a bare ``<paramfile> <obstaclefile>``
    # means ``run``.
    if argv and argv[0] not in _COMMANDS and not argv[0].startswith("-"):
        argv = ["run", *argv]
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())

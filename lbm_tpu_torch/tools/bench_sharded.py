"""Weak-scaling benchmark of the sharded path: the ``BASELINE.json``
``configs[4]`` case, a 4096x4096 grid over a row mesh or a 2-D mesh with
the halos exchanged between shards (the port of ``tools/bench_sharded.py``).

Builds the case (the canonical physics in a closed channel box, as
``lbm_tpu``'s tool), runs ``ShardedSimulator.run(readback="device")`` (the
upload, the loop and the av fetch are timed; f stays on the shards) and
prints one JSON line: total and per-shard MLUPS, µs per step, and the halo
bytes the exchange copies per step.  Shards map onto the visible CUDA
devices round-robin: where they share one card, the line says so, and its
rate is that card's with the exchange as local copies, not a multi-GPU
rate.

    python -m lbm_tpu_torch.tools.bench_sharded --shards 8
    python -m lbm_tpu_torch.tools.bench_sharded --mesh 4x2 --kernel temporal
    python -m lbm_tpu_torch.tools.bench_sharded --shards 2 --ny 8192 --nx 8192 \
        --temporal-split 32x4x2                      # the x-tiled route
    LBM_DEVICE=cpu python -m lbm_tpu_torch.tools.bench_sharded --ny 64 --nx 64 \\
        --max-iters 8 --shards 2 --repeats 1          # CPU smoke, plain torch
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.geometry import channel_box
from lbm_tpu_torch.parallel.mesh import default_mesh, default_mesh_2d
from lbm_tpu_torch.parallel.sharded import ShardedSimulator


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--shards", type=int, default=None,
                        help="1-D mesh size (default: one shard per visible device)")
    parser.add_argument("--mesh", default=None, metavar="PYxPX",
                        help="2-D mesh shape, e.g. 4x2 (overrides --shards)")
    parser.add_argument("--ny", type=int, default=4096)
    parser.add_argument("--nx", type=int, default=4096)
    parser.add_argument("--max-iters", type=int, default=2000)
    parser.add_argument("--kernel", default="auto",
                        choices=["auto", "fused", "temporal", "reference"])
    parser.add_argument("--temporal-split", default=None, metavar="BYxK[xPX]",
                        help="explicit temporal (BY, K), e.g. 32x4, or (BY, K, PX) "
                             "for the x-tiled route, e.g. 32x4x2")
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args(argv)
    if args.repeats < 1:
        raise SystemExit(f"--repeats must be >= 1, got {args.repeats}")

    params = LBMParams(args.nx, args.ny, args.max_iters, 10, 0.1, 0.005, 1.85)
    obstacles = channel_box(args.nx, args.ny)
    if args.mesh:
        py, px = (int(v) for v in args.mesh.lower().split("x"))
        mesh = default_mesh_2d(py, px)
        mesh_desc = f"{py}x{px} mesh"
    else:
        mesh = default_mesh(args.shards)
        mesh_desc = f"{mesh.size} row shards"
    split = None
    if args.temporal_split:
        split = tuple(int(v) for v in args.temporal_split.lower().split("x"))
    sim = ShardedSimulator(params, obstacles, mesh=mesh, kernel=args.kernel,
                           temporal_split=split)
    program = sim.compiled(args.max_iters)
    sim.run(readback="device")  # warm-up: allocator, first launches
    runs = [sim.run(readback="device") for _ in range(args.repeats)]
    best = min(r.elapsed for r in runs)

    n = mesh.size
    mlups = params.nx * params.ny * args.max_iters / best / 1e6
    devices = sorted({str(d) for d in mesh.local_devices()})
    # One exchange per launch fills each tile's halo: h rows of the owned
    # width above and below, h columns of the padded height on each side
    # (the x-tiled route: K ghost rows each side of a slab).
    halo_bytes = program.layout.halo_bytes() / program.chunk
    print(json.dumps({
        "metric": f"weak-scaling {params.ny}x{params.nx} over {mesh_desc}",
        "value": round(mlups / n, 1),
        "unit": "MLUPS/shard",
        "total_mlups": round(mlups, 1),
        "us_per_step": round(best / args.max_iters * 1e6, 2),
        "halo_bytes_per_step_per_shard": halo_bytes,
        "halo_bytes_per_step": halo_bytes * n,
        "shards": n,
        "devices": devices,
        "device_name": (torch.cuda.get_device_name(mesh.device(0, 0))
                        if devices[0].startswith("cuda") else "cpu"),
        "note": (f"every shard on {devices[0]}: one device's rate with local halo "
                 "copies, not a multi-GPU rate") if len(devices) == 1 else None,
        "max_iters": args.max_iters,
        "kernel": program.variant,
        "chunk": program.chunk,
        "av_last": float(runs[-1].av_vels[-1]),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Multi-process mesh validation (the port of ``tools/multihost_smoke.py``).

Runs a sharded mesh that spans ``--procs`` real ``torch.distributed``
processes (a gloo group over localhost; ``--local-devices`` shards each;
the halo pieces over the transport the program chooses by topology: card
to card over CUDA IPC for CUDA shards, gloo for CPU shards) and checks
what ``lbm_tpu``'s tool checks:

1. the sharded program runs across processes, each driving only its own
   shards and trading halo rows with the others over the group, and its
   final f is bitwise the single-device run's;
2. checkpointing writes per-process shard files, process 0 commits a meta
   covering every process's shards (on the mesh's slab lattice, with
   ``lbm_tpu``'s file names) after a barrier, and a half run resumed on the
   other mesh shape (1-D <-> 2-D) is bitwise the whole run.

Two checks go further: av is bitwise the same mesh's single-process run
(the sums add in mesh order on the host), and within rtol 1e-5 of the
single-device av.  A run over several processes never gathers the global f
in one process: every global comparison goes through the checkpoint files
in the shared directory.

Modes:

* coordinator (default): runs ``--single`` in a subprocess, then spawns
  ``--procs`` workers on an ephemeral port, waits (killing every worker
  when one fails or the time runs out) and prints PASS or FAIL, then one
  JSON line: the transport, each process count's µs a step, the exchange
  alone per transport (the chosen one and, beside the device transport,
  gloo, in turns) beside a launch's µs, and the kernel launches of the
  workers' checkpointed runs.
  Exit 0 only when every worker passed.
* ``--single``: the single-device run and the same mesh's single-process
  sharded run, written to ``ref.npz``.
* worker (``--rank R``): joins the group and runs the checks.

    LBM_DEVICE=cpu python -m lbm_tpu_torch.tools.multihost_smoke --procs 2
    LBM_DEVICE=cpu python -m lbm_tpu_torch.tools.multihost_smoke --mesh 2x2
    LBM_DEVICE=0 python -m lbm_tpu_torch.tools.multihost_smoke --grid 1024x1024 \\
        --steps 400 --kernel temporal                # the shard kernels, one card

Processes that share one card time-slice it, each with its own CUDA
context (no MPS): such a run shows correctness across processes and that
card's rate with two contexts, not a multi-GPU rate.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]  # where -m finds the package
STEPS = 40
GRID = "128x64"  # NXxNY, as the case names
SINGLE_TIMEOUT_S = 600
WORKER_TIMEOUT_S = 900
TIMED_RUNS = 2  # after one warm-up run
EXCHANGE_CALLS = 20
PLAIN_LAUNCHES = 2  # launches of the kernels held against their plain versions
AV_RTOL_SINGLE_DEVICE = 1e-5
AV_RTOL_PLAIN = 1e-6


class SmokeFailure(RuntimeError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _case(grid: str, steps: int):
    from lbm_tpu_torch.cli import _parse_pair
    from lbm_tpu_torch.config import LBMParams
    from lbm_tpu_torch.geometry import channel_box

    nx, ny = _parse_pair(grid, "--grid")
    params = LBMParams(nx, ny, steps, 10, 0.1, 0.005, 1.85)
    return params, channel_box(params.nx, params.ny, interior_row=29)


def _split(value: str | None) -> tuple[int, ...] | None:
    if value is None:
        return None
    try:
        split = tuple(int(p) for p in value.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--temporal-split must be BYxK or BYxKxPX, got {value!r}") from None
    if len(split) not in (2, 3):
        raise SystemExit(f"--temporal-split must be BYxK or BYxKxPX, got {value!r}")
    return split


def _mesh(n: int, shape: tuple[int, int] | None):
    from lbm_tpu_torch.parallel.mesh import default_mesh, default_mesh_2d

    return default_mesh(n) if shape is None else default_mesh_2d(*shape)


def _simulator(params, obstacles, mesh, kernel: str, split):
    from lbm_tpu_torch.parallel.sharded import ShardedSimulator

    return ShardedSimulator(params, obstacles, mesh=mesh, kernel=kernel,
                            temporal_split=split)


def _us_per_step(sim, steps: int) -> float:
    """The best of TIMED_RUNS ``readback="device"`` runs after a warm-up,
    µs a step (each timed from a barrier to its av on the host)."""
    sim.run(readback="device")
    return min(sim.run(readback="device").elapsed for _ in range(TIMED_RUNS)) / steps * 1e6


def single(args) -> int:
    """The single-device run and the same mesh's run in this one process,
    written to ``ref.npz`` (and their times to ``single.json``)."""
    from lbm_tpu_torch.runtime import Simulator

    params, obstacles = _case(args.grid, args.steps)
    n = args.procs * args.local_devices
    mesh_shape = _mesh_shape(args.mesh, n)
    one = Simulator(params, obstacles,
                    kernel="reference" if args.kernel == "reference" else "auto").run()
    sim = _simulator(params, obstacles, _mesh(n, mesh_shape), args.kernel,
                     _split(args.temporal_split))
    res = sim.run()
    workdir = pathlib.Path(args.workdir)
    np.savez(workdir / "ref.npz", f=one.f, av_vels=one.av_vels, f_mesh=res.f,
             av_mesh=res.av_vels)
    program = sim.compiled()
    (workdir / "single.json").write_text(json.dumps({
        "us_per_step": _us_per_step(sim, params.max_iters),
        "variant": program.variant, "chunk": program.chunk,
        "mesh": sim.mesh.describe()}))
    return 0


def _mesh_shape(mesh: str | None, n: int) -> tuple[int, int] | None:
    from lbm_tpu_torch.cli import _parse_pair

    if mesh is None:
        return None
    py, px = _parse_pair(mesh, "--mesh")
    if py * px != n:
        raise SystemExit(f"--mesh {mesh} has {py * px} shards, not procs x local "
                         f"devices = {n}")
    return py, px


def _resume_config(params, n: int, mesh_shape, split):
    """``lbm_tpu``'s resume mesh (1-D <-> 2-D) and the split it takes: the
    x-tiled form (BY, K, PX) needs one x shard, so a resume on a mesh of two
    columns takes (BY, K)."""
    if mesh_shape is not None and mesh_shape[1] > 1:
        return None, split
    if n >= 2 and params.ny % (n // 2) == 0:
        return (n // 2, 2), (split[:2] if split is not None else None)
    return mesh_shape, split


def _check_meta(ckdir: pathlib.Path, params, steps: int, n: int, mesh_shape) -> None:
    """The committed meta covers every process's shards, each on the mesh's
    slab lattice, with ``lbm_tpu``'s file names and shapes."""
    from lbm_tpu_torch import checkpoint as ckpt

    meta = json.loads((ckdir / ckpt.META_FILENAME).read_text())
    _require(len(meta["shards"]) == n, f"meta lists {len(meta['shards'])} shards, not {n}")
    py, px = mesh_shape if mesh_shape is not None else (n, 1)
    nyl, nxl = params.ny // py, params.nx // px
    want = {(i * nyl, j * nxl) for i in range(py) for j in range(px)}
    got = {(e["y0"], e["x0"]) for e in meta["shards"]}
    _require(got == want, f"meta offsets {sorted(got)} are not the slab lattice "
                          f"{sorted(want)}")
    for e in meta["shards"]:
        name = f"lbm_checkpoint.step{steps}.shard.y{e['y0']}.x{e['x0']}.npz"
        _require(e["file"] == name, f"shard file {e['file']}, not {name}")
        _require(e["shape"] == [9, nyl, nxl], f"shard {e['file']} shape {e['shape']}")
        with np.load(ckdir / e["file"]) as shard:
            _require(shard["f_local"].shape == (9, nyl, nxl),
                     f"{e['file']} holds {shard['f_local'].shape}")


def _equal(a, b, what: str) -> None:
    _require(np.array_equal(np.asarray(a), np.asarray(b)), f"{what}: not bitwise equal")


def _close(a, b, rtol: float, what: str) -> float:
    """The largest relative difference of ``a`` from ``b``, required within
    ``rtol``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    _require(a.shape == b.shape, f"{what}: shapes {a.shape} and {b.shape}")
    rel = float(np.max(np.abs(a - b) / np.abs(b))) if b.size else 0.0
    _require(rel <= rtol, f"{what}: max relative difference {rel} > {rtol}")
    return rel


def _exchange_times(program) -> dict:
    """One halo exchange of ``program`` alone, on synchronised streams
    (every process's shards from the uniform state), over the transport
    the program chose and, where that is the device transport, over the
    gloo group too, passed explicitly: from one barrier, the transports in
    turns (chosen, gloo, gloo, chosen), EXCHANGE_CALLS calls a turn, each
    turn ended by a device synchronisation.  Per transport, in µs a call:
    the whole exchange (the mean of its turns, and each turn), its
    ``start`` parts (sends packed and posted, local copies) and its
    ``finish`` parts (receives waited on and unpacked); and this process's
    pieces that cross, its messages a call on the program's transport, and
    one gloo message of the exchange's largest piece between host buffers
    of processes 0 and 1 alone (half a round trip)."""
    import torch

    from lbm_tpu_torch.parallel import dist
    from lbm_tpu_torch.parallel.halo import GroupTransport

    bufs, _ = program.alloc()
    program.upload(bufs)
    by_transport = {program.transport_kind: program.exchanges(bufs)}
    if program.transport_kind == "ipc":
        by_transport["gloo"] = program.exchanges(bufs, transport=GroupTransport())
    devices = [torch.device(d) for d in program.devices]

    def sync():
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    for exchanges in by_transport.values():
        exchanges[0]()  # first use: buffers touched, the group's pairs connected
    sync()
    dist.barrier("exchange timing")
    out = {name: {"turns_us": [], "start_us": 0.0, "finish_us": 0.0}
           for name in by_transport}
    for name in [*by_transport, *reversed(by_transport)]:
        exchanges, rec = by_transport[name], out[name]
        tic = time.perf_counter()
        for i in range(EXCHANGE_CALLS):
            ex = exchanges[i % len(exchanges)]
            for phase in range(len(ex.phases)):
                t0 = time.perf_counter()
                ex.start(phase)
                t1 = time.perf_counter()
                ex.finish(phase)
                rec["start_us"] += (t1 - t0) * 1e6
                rec["finish_us"] += (time.perf_counter() - t1) * 1e6
        sync()
        rec["turns_us"].append((time.perf_counter() - tic) / EXCHANGE_CALLS * 1e6)
    for rec in out.values():
        calls = EXCHANGE_CALLS * len(rec["turns_us"])
        rec.update(exchange_us=sum(rec["turns_us"]) / len(rec["turns_us"]),
                   start_us=rec["start_us"] / calls, finish_us=rec["finish_us"] / calls)
    chosen = by_transport[program.transport_kind][0]
    pieces = [m.view for ph in chosen.phases for m in ph.sends + ph.recvs]
    # The messages this process sends a call: one a peer a phase on the
    # device transport (a pack launch each), one a piece over gloo.
    link = chosen.link
    send_channels = (sum(len(c) for c in link.sends) if hasattr(link, "sends")
                     else sum(len(ph.sends) for ph in chosen.phases))
    largest = max(dist.all_gather_object(max((v.numel() for v in pieces), default=0)))
    message_us = None
    if largest:
        buf = torch.zeros(largest)
        dist.barrier("message timing")
        t0 = time.perf_counter()
        for _ in range(EXCHANGE_CALLS):
            if dist.process_index() == 0:
                torch.distributed.send(buf, dst=1)
                torch.distributed.recv(buf, src=1)
            elif dist.process_index() == 1:
                torch.distributed.recv(buf, src=0)
                torch.distributed.send(buf, dst=0)
        message_us = (time.perf_counter() - t0) / (2 * EXCHANGE_CALLS) * 1e6
    return {"exchange": out, "pieces": len(pieces), "send_channels": send_channels,
            "message_bytes": largest * 4, "message_us": message_us}


def _plain_check(program) -> dict:
    """``PLAIN_LAUNCHES`` launches of the shard kernels against their plain
    versions through this program (the exchange across processes in both):
    this process's tiles bitwise, av within AV_RTOL_PLAIN relative."""
    kernel_state, kernel_av = program.run(launches=PLAIN_LAUNCHES)
    plain_state, plain_av = program.run(launches=PLAIN_LAUNCHES, plain=True)
    err = 0.0
    for (_, _, k), (_, _, p) in zip(kernel_state.tiles, plain_state.tiles):
        err = max(err, float((k - p).abs().max()))
    _require(err == 0.0, f"the shard kernel is {err} off its plain version")
    rel = _close(kernel_av.cpu().numpy(), plain_av.cpu().numpy(), AV_RTOL_PLAIN,
                 "av against the plain version")
    return {"launches": PLAIN_LAUNCHES, "max_abs_err": err, "max_av_rtol": rel}


def worker(args) -> int:
    from lbm_tpu_torch import checkpoint as ckpt
    from lbm_tpu_torch.ops import fused
    from lbm_tpu_torch.parallel import dist

    dist.initialize(f"127.0.0.1:{args.port}", args.procs, args.rank)
    try:
        _require(dist.process_count() == args.procs,
                 f"{dist.process_count()} processes, not {args.procs}")
        params, obstacles = _case(args.grid, args.steps)
        n = args.procs * args.local_devices
        mesh_shape = _mesh_shape(args.mesh, n)
        split = _split(args.temporal_split)
        every = args.steps // 2
        mesh = _mesh(n, mesh_shape)
        _require(len(mesh.local_positions()) == args.local_devices,
                 f"this process owns {len(mesh.local_positions())} shards, not "
                 f"{args.local_devices}")
        workdir = pathlib.Path(args.workdir)
        ckdir = workdir / "ck"

        # Per-process shard writes and the cross-process commit; the
        # launches of this run are the main path's.
        sim = _simulator(params, obstacles, mesh, args.kernel, split)
        sim.compiled(every)
        fused.reset_launches()
        res = sim.run_checkpointed(str(ckdir), every=every)
        launches = {k: v for k, v in fused.LAUNCHES.items() if v}
        _require(res.steps_timed == params.max_iters, f"ran {res.steps_timed} steps")
        snap = ckpt.load(ckdir)
        _require(snap is not None and snap.step == params.max_iters,
                 "no snapshot of the last step")
        _check_meta(ckdir, params, args.steps, n, mesh_shape)

        with np.load(workdir / "ref.npz") as ref:
            _equal(snap.f, ref["f"], "f against the single-device run")
            _equal(snap.f, ref["f_mesh"], "f against the same mesh in one process")
            _equal(res.av_vels, ref["av_mesh"], "av against the same mesh in one process")
            _close(res.av_vels, ref["av_vels"], AV_RTOL_SINGLE_DEVICE,
                   "av against the single-device run")

            # A half run resumed on the other mesh shape is the whole run.
            ckdir2 = workdir / "ck2"
            half = _simulator(params, obstacles, mesh, args.kernel, split)
            half.run_checkpointed(str(ckdir2), every=every, max_iters=every)
            _require(ckpt.load(ckdir2).step == every, "no snapshot of the half run")
            resume_shape, resume_split = _resume_config(params, n, mesh_shape, split)
            resumed = _simulator(params, obstacles, _mesh(n, resume_shape), args.kernel,
                                 resume_split)
            res2 = resumed.run_checkpointed(str(ckdir2), every=every)
            _require(res2.steps_timed == args.steps - every,
                     f"the resume ran {res2.steps_timed} steps, not {args.steps - every}")
            _equal(ckpt.load(ckdir2).f, ref["f"], "the resumed f against the whole run")
            _close(res2.av_vels, ref["av_vels"], AV_RTOL_SINGLE_DEVICE,
                   "the resumed av against the single-device run")

        # A readback that gathers the global f refuses to run over processes.
        for readback in ("state", "fields") if args.procs > 1 else ():
            try:
                sim.run(readback=readback)
            except ValueError as e:
                _require("single-controller only" in str(e), f"readback {readback}: {e}")
            else:
                raise SmokeFailure(f"readback={readback!r} ran over {args.procs} processes")

        program = sim.compiled()
        report = {
            "rank": args.rank, "mesh": mesh.describe(), "transport": program.transport_kind,
            "resume_mesh": resumed.mesh.describe(), "variant": program.variant,
            "resume_variant": resumed.variant(every), "chunk": program.chunk,
            "launches": launches, "us_per_step": _us_per_step(sim, params.max_iters),
            **_exchange_times(program),
            "plain": (_plain_check(program) if program.variant != "reference" else None),
        }
        (workdir / f"rank{args.rank}.json").write_text(json.dumps(report))
        dist.barrier("done")
    finally:
        dist.shutdown()
    print(f"rank {args.rank}: PASS", flush=True)
    return 0


def _free_port() -> int:
    """An ephemeral port for rank 0's rendezvous (another process may take
    it between this probe and the bind: the usual ephemeral-port window)."""
    with socket.socket() as sock:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _wait_all(workers: list, timeout: float) -> list:
    """Every worker's exit code; when one fails or the time runs out, the
    rest are killed (a peer of a dead worker would wait on it)."""
    deadline = time.monotonic() + timeout
    try:
        while any(w.poll() is None for w in workers):
            if any(w.poll() for w in workers) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
            w.wait()
    return [w.returncode for w in workers]


def coordinator(args) -> int:
    with tempfile.TemporaryDirectory(prefix="lbm_mh_") as tmp:
        workdir = str(pathlib.Path(args.workdir or tmp).resolve())
        pathlib.Path(workdir).mkdir(parents=True, exist_ok=True)
        common = ["--procs", str(args.procs), "--local-devices", str(args.local_devices),
                  "--grid", args.grid, "--steps", str(args.steps), "--kernel", args.kernel,
                  "--workdir", workdir]
        if args.mesh:
            common += ["--mesh", args.mesh]
        if args.temporal_split:
            common += ["--temporal-split", args.temporal_split]
        me = [sys.executable, "-m", "lbm_tpu_torch.tools.multihost_smoke"]
        ref = subprocess.run([*me, "--single", *common], cwd=ROOT, timeout=SINGLE_TIMEOUT_S)
        if ref.returncode:
            print("FAIL: single-process reference run failed", flush=True)
            return 1
        port = _free_port()
        workers = [subprocess.Popen([*me, "--rank", str(rank), "--port", str(port), *common],
                                    cwd=ROOT)
                   for rank in range(args.procs)]
        codes = _wait_all(workers, WORKER_TIMEOUT_S)
        if any(codes):
            print(f"FAIL: worker exit codes {codes}", flush=True)
            return 1
        reports = [json.loads((pathlib.Path(workdir) / f"rank{r}.json").read_text())
                   for r in range(args.procs)]
        one = json.loads((pathlib.Path(workdir) / "single.json").read_text())
    topo = f"mesh {args.mesh}" if args.mesh else "1-D mesh"
    print(f"PASS: {args.procs} processes x {args.local_devices} devices ({topo})",
          flush=True)
    launches: dict[str, int] = {}
    for r in reports:
        for name, count in r["launches"].items():
            launches[name] = launches.get(name, 0) + count
    chunk = reports[0]["chunk"]
    us_step = max(r["us_per_step"] for r in reports)
    transport = reports[0]["transport"]
    # Per transport, the slowest process's exchange.
    exchange = {name: max((r["exchange"][name] for r in reports),
                          key=lambda e: e["exchange_us"])
                for name in reports[0]["exchange"]}
    exchange_us = {name: e["exchange_us"] for name, e in exchange.items()}
    print(json.dumps({
        "procs": args.procs, "local_devices": args.local_devices,
        "mesh": reports[0]["mesh"], "resume_mesh": reports[0]["resume_mesh"],
        "grid": args.grid, "steps": args.steps, "kernel": args.kernel,
        "temporal_split": args.temporal_split, "variant": reports[0]["variant"],
        "resume_variant": reports[0]["resume_variant"], "chunk": chunk,
        "device": os.environ.get("LBM_DEVICE", ""),
        "transport": transport,
        "us_per_step": us_step, "us_per_step_one_process": one["us_per_step"],
        "one_process_variant": one["variant"],
        "exchange_us": exchange_us, "exchange": exchange, "launch_us": us_step * chunk,
        "exchange_share_of_launch": exchange_us[transport] / (us_step * chunk),
        "pieces": max(r["pieces"] for r in reports),
        "send_channels": sum(r["send_channels"] for r in reports),
        "message_bytes": reports[0]["message_bytes"], "message_us": reports[0]["message_us"],
        "launches": launches, "plain": [r["plain"] for r in reports],
    }), flush=True)
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--procs", type=int, default=2)
    parser.add_argument("--local-devices", type=int, default=2,
                        help="shards each process owns")
    parser.add_argument("--mesh", default=None, metavar="PYxPX",
                        help="2-D mesh spanning all processes (default: 1-D); py*px "
                             "must equal procs*local_devices")
    parser.add_argument("--grid", default=GRID, metavar="NXxNY")
    parser.add_argument("--steps", type=int, default=STEPS,
                        help="steps of the whole run; the checkpoint interval and "
                             "the half run are half of it")
    parser.add_argument("--kernel", default="reference",
                        choices=["reference", "fused", "temporal"])
    parser.add_argument("--temporal-split", default=None, metavar="BYxK[xPX]")
    parser.add_argument("--rank", type=int, default=None)
    parser.add_argument("--single", action="store_true")
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--port", type=int, default=None)
    args = parser.parse_args(argv)
    if args.procs < 1 or args.local_devices < 1:
        parser.error("--procs and --local-devices must be positive")
    if args.steps < 2 or args.steps % 2:
        parser.error(f"--steps must be even and at least 2, got {args.steps}")
    _mesh_shape(args.mesh, args.procs * args.local_devices)  # exits on a bad --mesh
    if args.single:
        if args.workdir is None:
            parser.error("--single needs --workdir")
        return single(args)
    if args.rank is not None:
        if args.port is None or args.workdir is None:
            parser.error("--rank needs --port (the coordinator's ephemeral port) and "
                         "--workdir")
        return worker(args)
    return coordinator(args)


if __name__ == "__main__":
    sys.exit(main())

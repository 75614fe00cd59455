"""Step-kernel ablation at 1024x1024 on the card: where do the microseconds
go?  The port of ``tools/ablate_step.py``; its kernels are
``csrc/lbm_ablate.cu`` (the port of ``_ablated_kernel``).

Times four kernels that share the temporal kernel's schedule and code
(persistent blocks walking BY x BX tiles, K steps a pass, each tile's
(BY + 2K) x (BX + 2K) window copied into the same shared memory by
``cp.async`` while the previous tile steps, ping-pong f_in -> f_out, the
last step stored straight to f_out) with the physics removed stage by
stage:

* ``noop``    — load each window and its mask, copy its centre to f_out;
* ``stream``  — and K pull-streams between the window buffers (no kick,
  no collision);
* ``collide`` — the full per-cell update (kick, pull, BGK, bounce-back)
  without the |u| partials;
* ``full``    — the production kernel (``lbm_temporal_step``).

It prints ``lbm_tpu``'s JSON lines, one per mode and then
``attribution_us``, whose keys read on Hopper as:

* ``dma_overhead`` (noop): the global<->shared loads and stores of the
  windows, as much of them as the schedule leaves exposed, and the
  launches;
* ``streaming_rolls`` (stream - noop): the K pull moves between the two
  shared-memory window buffers;
* ``kick_and_collision`` (collide - stream): the kick, BGK relaxation and
  bounce-back arithmetic (IEEE division, no FMA contraction);
* ``av_reduction`` (full - collide): each cell's |u| (its sqrt) and the
  block's fixed-order |u| sum with its barriers, and the av reduction
  kernel.

Times are per step, by CUDA events over a bound loop of whole passes, best
of three, taken in turns (noop, stream, collide, full, then back); a mode's
time is the mean of its two turns.  The defaults are the chooser's 1024^2
tile, 32 x 64 with K 4 (``lbm_tpu``'s 128-row window at K 8 does not fit a
block's shared memory).  Run on the card, or with ``LBM_DEVICE=cpu`` for
the plain versions (host times, not the card's)::

    python -m lbm_tpu_torch.tools.ablate_step [--by 32] [--bx 64] [--k 4] [--steps 4800]
    LBM_DEVICE=cpu python -m lbm_tpu_torch.tools.ablate_step --steps 8
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time

import numpy as np
import torch

from lbm_tpu_torch.config import CANONICAL_PARAMS, LBMParams
from lbm_tpu_torch.geometry import canonical_obstacles, free_cells_of
from lbm_tpu_torch.ops import _build, fused, schedule
from lbm_tpu_torch.ops.lattice import CX, CY, NSPEEDS
from lbm_tpu_torch.ops.reference import init_cells, make_masked_step_fn
from lbm_tpu_torch.runtime import select_device

MODES = ("noop", "stream", "collide")


class AblatedStep(torch.nn.Module):
    """One ablated temporal pass (``lbm_ablate_<mode>``): ``ksteps`` steps
    of ``by x bx`` tiles, reading one bound buffer and writing the other.
    CUDA tensors launch the kernel, CPU tensors take the plain version:
    the identity (``noop``), K ``torch.roll`` pulls (``stream``) or K plain
    one-steps (``collide``)."""

    def __init__(self, mode: str, params: LBMParams, obstacles: np.ndarray,
                 device: torch.device, by: int, bx: int, ksteps: int) -> None:
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        check_tile(params.ny, params.nx, by, bx, ksteps)
        device = torch.device(device)
        lib = None if device.type == "cpu" else _build.load_library()
        self.mode, self.kernel = mode, f"lbm_ablate_{mode}"
        self.params, self.by, self.bx, self.chunk = params, by, bx, ksteps
        fluid = ~np.asarray(obstacles, dtype=bool)
        self.register_buffer("fluid", torch.as_tensor(fluid.astype(np.uint8), device=device))
        # The production kernel's persistent grid.
        tiles = (params.ny // by) * (params.nx // bx)
        self.nblocks = (0 if lib is None else
                        fused.persistent_blocks(lib, self.fluid.device, tiles, by, bx, ksteps))
        fcinv = np.float32(1.0) / np.float32(free_cells_of(obstacles))
        self._consts = fused.step_params(params, fcinv)
        self._step = make_masked_step_fn(params, fcinv)

    def plain_launch(self, f: torch.Tensor) -> torch.Tensor:
        """One pass in plain torch: ``f`` after the mode's K steps."""
        if self.mode == "noop":
            return f.clone()
        fluid = self.fluid.bool()
        for _ in range(self.chunk):
            if self.mode == "stream":
                f = torch.stack([torch.roll(f[q], (int(CY[q]), int(CX[q])), dims=(-2, -1))
                                 for q in range(NSPEEDS)])
            else:
                f, _ = self._step(f, fluid)
        return f

    def bind(self, f_a: torch.Tensor, f_b: torch.Tensor):
        """``launch(i)``: pass ``i`` reads ``(f_a, f_b)[i & 1]`` and writes
        the other."""
        bufs = (f_a, f_b)
        if fused.runs_plain(f_a):

            def plain(i: int) -> None:
                bufs[~i & 1].copy_(self.plain_launch(bufs[i & 1]))

            return plain
        shape = (NSPEEDS, self.params.ny, self.params.nx)
        for x in bufs:
            if (x.device != self.fluid.device or x.dtype != torch.float32
                    or tuple(x.shape) != shape or not x.is_contiguous()):
                raise ValueError(f"buffers must be contiguous float32 {shape} on "
                                 f"{self.fluid.device}, got {x.dtype} {tuple(x.shape)} on "
                                 f"{x.device}")
        if f_a.data_ptr() == f_b.data_ptr():
            raise ValueError("f_a and f_b must be distinct buffers (ping-pong)")
        lib = _build.load_library()
        ptrs = (f_a.data_ptr(), f_b.data_ptr())
        fluid, consts = self.fluid.data_ptr(), ctypes.addressof(self._consts)
        args = (self.by, self.bx, self.chunk, self.nblocks)
        stream = torch.cuda.current_stream(f_a.device).cuda_stream

        def launch(i: int) -> None:
            fused._launch(lib, self.kernel, ptrs[i & 1], ptrs[~i & 1], fluid, consts, *args,
                          stream)

        return launch


def check_tile(ny: int, nx: int, by: int, bx: int, ksteps: int) -> None:
    """ValueError unless the tile divides the grid, K >= 1 and the
    persistent kernel's windows fit a block's shared memory
    (:func:`schedule.persistent_fits`: the temporal kernel's
    constraints)."""
    if by < 1 or bx < 1 or ny % by or nx % bx:
        raise ValueError(f"tile {by}x{bx} does not divide grid {ny}x{nx}")
    if ksteps < 1:
        raise ValueError(f"K must be >= 1, got {ksteps}")
    if not schedule.persistent_fits(by, bx, ksteps):
        raise ValueError(f"the window of tile {by}x{bx} at K {ksteps} needs "
                         f"{schedule.persistent_smem_bytes(by, bx, ksteps)} B of shared "
                         f"memory, more than a block's {schedule.PERSISTENT_SMEM_BUDGET}")


def programs(params, obstacles, device, by, bx, ksteps) -> dict:
    """The four modes' programs: the three ablated passes and the
    production temporal kernel (``full``)."""
    fcinv = np.float32(1.0) / np.float32(free_cells_of(obstacles))
    progs = {m: AblatedStep(m, params, obstacles, device, by, bx, ksteps) for m in MODES}
    progs["full"] = fused.TemporalStep(params, obstacles, fcinv, device, by, bx, ksteps)
    return progs


def bound_loop(prog, f0: torch.Tensor):
    """``run(passes)``: advances one bound ping-pong state of ``prog`` by
    whole passes (the production kernel's av cycling over 64 passes)."""
    bufs = (f0.clone(), torch.empty_like(f0))
    if isinstance(prog, AblatedStep):
        launch = prog.bind(*bufs)
        cap = None
    else:
        cap = 64
        av = torch.empty(cap * prog.chunk, dtype=torch.float32, device=f0.device)
        launch = prog.bind(*bufs, av)
    state = {"i": 0}

    def run(passes: int) -> None:
        for _ in range(passes):
            launch(state["i"] % cap if cap else state["i"])
            state["i"] += 1

    return run


def _seconds(run, passes: int, device: torch.device) -> float:
    if device.type != "cuda":
        tic = time.perf_counter()
        run(passes)
        return time.perf_counter() - tic
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run(passes)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e-3


def time_modes(params, obstacles, device, by, bx, ksteps, steps, order=None) -> dict:
    """Microseconds per step of each mode, in turns (``order``, default
    noop, stream, collide, full and back): each turn the best of three
    timed loops of ``steps // ksteps`` whole passes, after one warm-up
    pass.  Returns {mode: [us per step of each turn]}."""
    order = order or [*MODES, "full", "full", *MODES[::-1]]
    passes = steps // ksteps
    f0 = init_cells(params, device)
    loops = {m: bound_loop(p, f0) for m, p in programs(params, obstacles, device, by, bx,
                                                         ksteps).items()}
    out = {m: [] for m in loops}
    for m in order:
        loops[m](1)  # warm-up
        best = min(_seconds(loops[m], passes, device) for _ in range(3))
        out[m].append(best / (passes * ksteps) * 1e6)
    return out


def attribution(us: dict) -> dict:
    """``lbm_tpu``'s ``attribution_us`` from the modes' µs per step."""
    return {
        "dma_overhead": us["noop"],
        "streaming_rolls": us["stream"] - us["noop"],
        "kick_and_collision": us["collide"] - us["stream"],
        "av_reduction": us["full"] - us["collide"],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--by", type=int, default=32)
    parser.add_argument("--bx", type=int, default=64)
    parser.add_argument("--k", type=int, default=4)
    parser.add_argument("--steps", type=int, default=4800)
    args = parser.parse_args(argv)
    params = CANONICAL_PARAMS["1024x1024"]
    try:
        check_tile(params.ny, params.nx, args.by, args.bx, args.k)
    except ValueError as e:
        parser.error(str(e))
    if args.steps < args.k:
        parser.error(f"--steps ({args.steps}) must be >= --k ({args.k}): "
                     "the timer runs whole K-passes")
    device = select_device(None)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    turns = time_modes(params, canonical_obstacles("1024x1024"), device, args.by, args.bx,
                       args.k, args.steps)
    us = {m: sum(t) / len(t) for m, t in turns.items()}
    for m, t in turns.items():
        print(json.dumps({"mode": m, "us_per_step": us[m], "turns": t}), flush=True)
    print(json.dumps({"attribution_us": attribution(us), "tile": [args.by, args.bx],
                      "k": args.k, "steps": args.steps // args.k * args.k,
                      "device": name}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

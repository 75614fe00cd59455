"""Giant-grid validation on the card, one command per claim (the port of
``tools/validate_giant.py``):

  kernel  — time the x-tiled schedule's pass with CUDA events (us/step and
            GLUPS, this card's own rate), and hold one launch against its
            plain version (f bitwise, av within 1e-6 relative)
  fields  — ``Simulator.run(readback="fields")`` end to end
  ckpt    — checkpointed run: the fresh phase runs ``steps`` steps and
            snapshots; the resume phase continues the same directory to
            2 * steps; prints the av endpoint to hold against an
            uninterrupted run of the same length

``fields`` and ``ckpt`` run what the schedule picks: the row temporal
kernel where the card holds a ping-pong pair of the grid, the x-tiled
in-place kernel (and, checkpointed, the carry-resident driver) where it
does not.

Usage (from the repository root, on a machine with a CUDA card)::

    python -m lbm_tpu_torch.tools.validate_giant kernel --n 8192
    python -m lbm_tpu_torch.tools.validate_giant fields --n 16384 --steps 192
    python -m lbm_tpu_torch.tools.validate_giant ckpt --n 8192 --steps 192
    python -m lbm_tpu_torch.tools.validate_giant ckpt --n 8192 --steps 192 --resume

Pass and fail come from correctness (finite, equal to the plain version,
the right number of steps); the times are printed, not judged.  With
``LBM_DEVICE=cpu`` the ``fields`` and ``ckpt`` phases run the plain path
at small ``--n``.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np
import torch

from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.geometry import channel_box, free_cells_of
from lbm_tpu_torch.ops import fused, schedule
from lbm_tpu_torch.runtime import Simulator, select_device

DEFAULT_CKPT_DIR = (pathlib.Path(__file__).resolve().parents[2] / "build"
                    / "validate_giant_ckpt")
AV_RTOL = 1e-6


def setup(n: int, steps: int) -> tuple[LBMParams, np.ndarray]:
    """The giant-grid case (1024^2's physics at size n), one definition for
    every phase so that they cannot validate different physics."""
    return LBMParams(n, n, steps, 10, 0.1, 0.01, 1.85), channel_box(n, n)


def kernel(n: int, steps: int) -> dict:
    """Time ``steps`` steps of the x-tiled pass at n^2 by CUDA events, and
    check one launch against the plain version; raises where the x-tiled
    schedule would not take the run (:func:`schedule.choose_temporal_xtiled`)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the kernel phase needs a CUDA card")
    picked = schedule.choose_temporal_xtiled(n, n, steps)
    if picked is None:
        raise ValueError(f"the x-tiled schedule does not take {n}^2 x {steps}")
    by, bx, k = picked
    params, obstacles = setup(n, steps)
    fcinv = np.float32(1.0) / np.float32(free_cells_of(obstacles))
    dev = torch.device("cuda", torch.cuda.current_device())
    prog = fused.TemporalXtStep(params, obstacles, fcinv, dev, by, bx, k)
    # Two launches from the uniform state first, so that the launch held
    # against the plain version starts from non-uniform bands.
    carry = prog.init(Simulator(params, obstacles, device=dev).initial_state())
    av = torch.empty(steps, dtype=torch.float32, device=dev)
    launch = prog.bind_carry(carry, av)
    launch(0)
    launch(0)
    f_w = carry.f.clone()
    del carry, launch
    one, one_av = prog.single(f_w)
    plain, plain_av = prog.plain_launch(f_w)
    torch.cuda.synchronize()
    f_equal = bool(torch.equal(one, plain))
    av_rel = ((one_av - plain_av).abs() / plain_av.abs()).max().item()
    del one, plain

    carry = prog.init(f_w)
    launch = prog.bind_carry(carry, av)
    launch(0)  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(steps // k):
        launch(i)
    end.record()
    torch.cuda.synchronize()
    us = start.elapsed_time(end) * 1e3 / steps
    finite = bool(torch.isfinite(carry.f).all() and torch.isfinite(av).all())
    return {"n": n, "tile": [by, bx], "k": k, "steps": steps, "us_per_step": us,
            "glups": n * n / us / 1e3, "f_equal_plain": f_equal,
            "av_rel_plain": av_rel, "finite": finite,
            "ok": finite and f_equal and av_rel <= AV_RTOL}


def fields(n: int, steps: int, device=None) -> dict:
    """``Simulator.run(readback="fields")`` at n^2 x steps."""
    params, obstacles = setup(n, steps)
    sim = Simulator(params, obstacles, device=device)
    tic = time.perf_counter()
    res = sim.run(readback="fields")
    av = np.asarray(res.av_vels)
    ok = (res.fields is not None and res.fields.shape == (4, n, n)
          and bool(np.isfinite(av).all()) and av.shape == (steps,)
          and bool(np.isfinite(res.fields).all()))
    return {"n": n, "steps": steps, "program": type(sim.program).__name__,
            "elapsed_s": res.elapsed, "wall_s": time.perf_counter() - tic,
            "steps_per_pass": res.steps_per_pass, "av_last": float(av[-1]),
            "mlups": res.mlups, "ok": ok}


def _has_checkpoint(ckpt_dir) -> bool:
    return any(pathlib.Path(ckpt_dir).glob("lbm_checkpoint*"))


def ckpt(n: int, steps: int, resume: bool, ckpt_dir, device=None) -> dict:
    """The fresh phase (``steps`` steps into an empty ``ckpt_dir``) or the
    resume phase (to ``2 * steps`` from the fresh phase's snapshot).

    ``run_checkpointed`` resumes from whatever the directory holds, so each
    phase checks the directory first, or it validates nothing: a fresh run
    on a left-over snapshot runs no step, and a resume on an empty
    directory never exercises the resume path."""
    if not resume and _has_checkpoint(ckpt_dir):
        raise ValueError(f"{ckpt_dir} already holds a checkpoint: delete it or "
                         f"pass --resume")
    if resume and not _has_checkpoint(ckpt_dir):
        raise ValueError(f"no checkpoint in {ckpt_dir}: run the fresh phase first")
    total = 2 * steps if resume else steps
    params, obstacles = setup(n, total)
    sim = Simulator(params, obstacles, device=device)
    tic = time.perf_counter()
    res = sim.run_checkpointed(str(ckpt_dir), every=steps, max_iters=total)
    av = np.asarray(res.av_vels)
    ok = bool(np.isfinite(av).all()) and len(av) == total
    # The resume phase must have resumed: it runs only the second half.
    if resume and res.steps_timed != steps:
        ok = False
    return {"n": n, "phase": "resume" if resume else "fresh", "steps": total,
            "steps_timed": res.steps_timed, "elapsed_s": res.elapsed,
            "wall_s": time.perf_counter() - tic, "av_last": float(av[-1]),
            "av": av, "f": res.f, "ok": ok}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=["kernel", "fields", "ckpt"])
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=192)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    args = ap.parse_args(argv)
    if args.what == "kernel":
        rec = kernel(args.n, args.steps)
        detail = (f"tile {rec['tile'][0]}x{rec['tile'][1]} K {rec['k']}: "
                  f"{rec['us_per_step']:.2f} us/step = {rec['glups']:.2f} GLUPS on "
                  f"{torch.cuda.get_device_name()}; one launch against the plain "
                  f"version: f equal {rec['f_equal_plain']}, av rel "
                  f"{rec['av_rel_plain']:.3e}")
    elif args.what == "fields":
        rec = fields(args.n, args.steps, select_device())
        detail = (f"x{rec['steps']} through {rec['program']}: elapsed "
                  f"{rec['elapsed_s']:.3f} s, wall {rec['wall_s']:.1f} s, "
                  f"steps_per_pass {rec['steps_per_pass']}, av[-1] {rec['av_last']:.6e}")
    else:
        rec = ckpt(args.n, args.steps, args.resume, args.ckpt_dir, select_device())
        detail = (f"({rec['phase']}) steps_timed {rec['steps_timed']}, wall "
                  f"{rec['wall_s']:.1f} s, av[{rec['steps'] - 1}] {rec['av_last']:.6e} "
                  f"(must equal an uninterrupted {rec['steps']}-step run's value)")
    print(f"{'PASS' if rec['ok'] else 'FAIL'} {args.what} {args.n}^2 {detail}")
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

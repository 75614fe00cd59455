"""The card's practical issue-rate ceiling for the port's kernels: the
counterpart of ``tools/vpu_roofline.py`` (its Pallas ``body`` is
``csrc/lbm_roofline.cu``).

The temporal kernels run well below their bytes bound, so "how fast can a
step possibly go" needs a second denominator: the element-op rate a kernel
of THIS build reaches, not a datasheet number.  Every kernel of the port
is built with ``-fmad=false`` and IEEE division and sqrt, so ``a * b + c``
is two instructions and a division or sqrt is a short routine.

Method, as ``vpu_roofline.py``: ``rows * 128`` fp32 elements, each carried
by one thread through ``inner`` iterations of one of three recurrences
(``a`` and ``b`` kernel arguments, every result stored, so nothing
folds), one launch feeding the next ``steps`` times, timed by CUDA events,
best of three:

* ``add``  — x = x + b, ``unroll`` times an iteration (1 op each);
* ``fma``  — x = x * a + b, ``unroll`` times an iteration (2 ops each, a
  multiply and an add in this build);
* ``mix``  — ``lbm_tpu``'s 106-op blend once an iteration (91 add, sub,
  mul and select-adds, 10 selects, a compare, two adds, an IEEE division
  and an IEEE sqrt): the production per-cell op mix (104 ops,
  ``tests/test_perf_model.py``).

Counting every op as one issue, it prints ``lbm_tpu``'s JSON line per mix
(``Gissue_per_s``) and, for ``mix``, the cell-update ceiling it implies
(the rate over 106).  Each element is an independent chain, so the card
hides an op's latency only with many warps in flight: the default ``rows``
(16896: 2,162,688 elements, 8 waves of 132 SMs x 2048 resident threads)
fills every SM.  Run on the card, or with ``LBM_DEVICE=cpu`` for the plain
versions (host rates, not the card's)::

    python -m lbm_tpu_torch.tools.roofline [--rows 16896] [--unroll 64] \\
        [--inner 200] [--steps 30] [--mixes add,fma,mix]
    LBM_DEVICE=cpu python -m lbm_tpu_torch.tools.roofline --rows 8 --inner 2 --steps 1
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from lbm_tpu_torch.ops import _build, fused
from lbm_tpu_torch.runtime import select_device

MIXES = ("add", "fma", "mix")
# lbm_tpu's constants: a just above 1, b tiny, as fp32.
A = np.float32(1.0000001)
B = np.float32(1e-30)
# Ops an iteration of the mix blend (vpu_roofline.py's count).
MIX_ISSUES = 106
LANES = 128


def issues_per_iteration(mix: str, unroll: int) -> int:
    """``vpu_roofline``'s traced ops per element and iteration."""
    if mix == "add":
        return unroll
    if mix == "fma":
        return 2 * unroll
    if mix == "mix":
        return MIX_ISSUES
    raise ValueError(f"mix must be one of {MIXES}, got {mix!r}")


def plain(mix: str, x: torch.Tensor, inner: int, unroll: int, a: float = A,
          b: float = B) -> torch.Tensor:
    """The recurrence in plain torch, op for op as the kernel (fp32 0-d
    tensors for a and b, so every op rounds to fp32)."""
    issues_per_iteration(mix, unroll)  # validates the mix
    a = torch.tensor(np.float32(a), device=x.device)
    b = torch.tensor(np.float32(b), device=x.device)
    one = torch.tensor(np.float32(1.0), device=x.device)
    half = torch.tensor(np.float32(0.5), device=x.device)
    for _ in range(inner):
        if mix == "add":
            for _ in range(unroll):
                x = x + b
        elif mix == "fma":
            for _ in range(unroll):
                x = x * a + b
        else:
            m = x > half
            for _ in range(10):
                x = (x + b) * a - b
            for _ in range(20):
                x = x + b
            for _ in range(20):
                x = x * a
            for _ in range(11):
                x = x - b
            for _ in range(10):
                x = torch.where(m, x, x + b)
            x = one / (x + one)
            x = torch.sqrt(x + one)
    return x


def launch(mix: str, x: torch.Tensor, out: torch.Tensor, inner: int, unroll: int,
           a: float = A, b: float = B) -> None:
    """``out = mix^inner(x)``: CUDA tensors launch ``lbm_roofline_<mix>``,
    CPU tensors take the plain version.  ``a`` and ``b`` default to
    ``lbm_tpu``'s constants; at those, ``x + b`` leaves an x of order 1
    unchanged, so a check of the kernel passes a ``b`` that moves x."""
    issues_per_iteration(mix, unroll)
    if fused.runs_plain(x):
        out.copy_(plain(mix, x, inner, unroll, a, b))
        return
    lib = _build.load_library()
    for name, t in (("x", x), ("out", out)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor on {x.device}")
    if out.numel() != x.numel() or out.data_ptr() == x.data_ptr():
        raise ValueError("out must be a distinct buffer of x's size")
    fused._launch(lib, f"lbm_roofline_{mix}", x.data_ptr(), out.data_ptr(), x.numel(),
                  inner, unroll, float(np.float32(a)), float(np.float32(b)),
                  torch.cuda.current_stream(x.device).cuda_stream)


def measure(mix: str, rows: int, unroll: int, inner: int, steps: int,
            device: torch.device) -> dict:
    """Best of three chains of ``steps`` launches from x = 1 (each feeding
    the next), after one warm-up chain: ``vpu_roofline``'s JSON record."""
    issues = issues_per_iteration(mix, unroll)
    bufs = [torch.ones(rows * LANES, dtype=torch.float32, device=device),
            torch.empty(rows * LANES, dtype=torch.float32, device=device)]

    def chain() -> None:
        for i in range(steps):
            launch(mix, bufs[i & 1], bufs[~i & 1], inner, unroll)

    chain()
    best = float("inf")
    for _ in range(3):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain()
            end.record()
            torch.cuda.synchronize()
            seconds = start.elapsed_time(end) * 1e-3
        else:
            tic = time.perf_counter()
            chain()
            seconds = time.perf_counter() - tic
        best = min(best, seconds)
    rate = rows * LANES * inner * steps * issues / best
    rec = {"mix": mix, "traced_ops_per_elem_iter": issues, "seconds": best,
           "Gissue_per_s": rate / 1e9}
    if mix == "mix":
        rec["cell_updates_per_s_ceiling"] = rate / MIX_ISSUES
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rows", type=int, default=16896)
    p.add_argument("--unroll", type=int, default=64)
    p.add_argument("--inner", type=int, default=200)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--mixes", default="add,fma,mix", help="comma list: add,fma,mix")
    args = p.parse_args(argv)
    mixes = args.mixes.split(",")
    if any(m not in MIXES for m in mixes):
        p.error(f"--mixes must name {MIXES}, got {args.mixes!r}")
    if min(args.rows, args.unroll, args.steps) < 1 or args.inner < 0:
        p.error("--rows, --unroll and --steps must be >= 1, --inner >= 0")
    device = select_device(None)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {name}", file=sys.stderr)
    for mix in mixes:
        rec = measure(mix, args.rows, args.unroll, args.inner, args.steps, device)
        print(json.dumps({**rec, "device": name}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

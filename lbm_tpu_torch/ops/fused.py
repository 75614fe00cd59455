"""The fused one-step program: a hand-written CUDA kernel and its plain
torch version.

Port of ``lbm_tpu.ops.fused.build_fused_program`` (the Pallas kernels
``_step_kernel_single`` and ``_step_kernel_blocked``).  One timestep —
body-force kick of row ny-2, pull-stream with periodic wrap, BGK with
bounce-back, and the mean |u| over fluid cells — in one pass over
``f[9, ny, nx]``.  The CUDA kernel lives in ``csrc/lbm_step.cu``; its head
note says how it is laid out.

A step program is ping-pong: ``program(f_in, f_out, av, t)`` reads
``f_in``, writes ``f_out`` and ``av[t]``.  A run binds its two buffers and
``av`` once (``program.bind(f_a, f_b, av)``), which checks them once and
returns ``launch(t)``: step ``t`` reads ``f_a`` when ``t`` is even and
``f_b`` when it is odd.  :class:`FusedStep` launches the
kernel for CUDA tensors and runs the plain torch version (built from
:mod:`lbm_tpu_torch.ops.reference`) for CPU tensors, and for nothing else:
on any other device it launches or raises.  :class:`ReferenceStep` runs the
plain version on any device (``kernel="reference"``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.ops import _build
from lbm_tpu_torch.ops.lattice import NSPEEDS, WEIGHTS, kick_scale
from lbm_tpu_torch.ops.reference import accel_weights, make_masked_step_fn

# Kernel launches made by FusedStep (one per step; plain-torch steps on
# the CPU do not count).  A run that went through the kernel shows it here.
LAUNCHES = 0


def _launch(lib, *args) -> None:
    """``lbm_fused_step(f_in, f_out, fluid, partials, av_t, params, stream)``
    on device pointers; raises on a launch error, counts a launch."""
    global LAUNCHES
    rc = lib.lbm_fused_step(*args)
    if rc != 0:
        raise RuntimeError(
            f"lbm_fused_step launch failed: {lib.lbm_error_string(rc).decode()}"
        )
    LAUNCHES += 1


class _StepParams(ctypes.Structure):
    """Mirrors ``StepParams`` in ``csrc/lbm_step.cu`` field for field."""

    _fields_ = [
        ("ny", ctypes.c_int),
        ("nx", ctypes.c_int),
        ("omega", ctypes.c_float),
        ("aw1", ctypes.c_float),
        ("aw2", ctypes.c_float),
        ("free_cells_inv", ctypes.c_float),
        ("weights", ctypes.c_float * NSPEEDS),
        ("kick", ctypes.c_float * NSPEEDS),
    ]


def step_params(params: LBMParams, free_cells_inv: np.float32) -> _StepParams:
    """The kernel's constants as the same fp32 values ``lbm_tpu`` uses
    (``np.float32(omega)``, ``accel_weights``, ``WEIGHTS``); a Python
    float holding an fp32 value converts to ``c_float`` exactly."""
    aw1, aw2 = accel_weights(params)
    kick = [kick_scale(k, aw1, aw2) for k in range(NSPEEDS)]
    return _StepParams(
        ny=params.ny,
        nx=params.nx,
        omega=float(np.float32(params.omega)),
        aw1=float(aw1),
        aw2=float(aw2),
        free_cells_inv=float(np.float32(free_cells_inv)),
        weights=(ctypes.c_float * NSPEEDS)(*map(float, WEIGHTS)),
        kick=(ctypes.c_float * NSPEEDS)(
            *(0.0 if s is None else float(np.float32(s)) for s in kick)
        ),
    )


class StepProgram(torch.nn.Module):
    """One timestep of one grid and physics configuration, as a ping-pong
    update ``forward(f_in, f_out, av, t)`` or a bound run (:meth:`bind`).
    Holds the fluid mask (uint8, 1 = fluid) as a buffer; :meth:`plain` is
    the functional plain-torch step."""

    def __init__(
        self,
        params: LBMParams,
        obstacles: np.ndarray,
        free_cells_inv: np.float32,
        device: torch.device,
    ) -> None:
        super().__init__()
        fluid = ~np.asarray(obstacles, dtype=bool)
        if fluid.shape != params.shape:
            raise ValueError(f"obstacle mask {fluid.shape} != grid {params.shape}")
        self.params = params
        self.register_buffer(
            "fluid", torch.as_tensor(fluid.astype(np.uint8), device=device)
        )
        self._masked = make_masked_step_fn(params, free_cells_inv)

    def plain(self, f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``f -> (f', av)`` in plain torch, on ``f``'s device."""
        return self._masked(f, self.fluid.bool())

    def single(self, f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``f -> (f', av)`` through :meth:`forward` (allocates the output)."""
        out = torch.empty_like(f)
        av = torch.empty(1, dtype=torch.float32, device=f.device)
        self(f, out, av, 0)
        return out, av[0]

    def bind(self, f_a: torch.Tensor, f_b: torch.Tensor, av: torch.Tensor):
        """``launch(t)`` for a ping-pong run over ``(f_a, f_b)``: step ``t``
        reads ``f_a`` if ``t`` is even, else ``f_b``, and writes ``av[t]``."""
        bufs = (f_a, f_b)

        def launch(t: int) -> None:
            self._plain_into(bufs[t & 1], bufs[~t & 1], av, t)

        return launch

    def _plain_into(self, f_in, f_out, av, t) -> None:
        f_new, a = self.plain(f_in)
        f_out.copy_(f_new)
        av[t] = a


class ReferenceStep(StepProgram):
    """The plain torch step on any device (``kernel="reference"``)."""

    def forward(self, f_in, f_out, av, t) -> None:
        self._plain_into(f_in, f_out, av, t)


class FusedStep(StepProgram):
    """The fused one-step kernel: CUDA tensors launch ``lbm_fused_step``,
    CPU tensors take the plain version; anything else raises.

    Constructing it for a non-CPU device builds the kernel library first
    (outside any timed region), so a failed build raises here."""

    def __init__(self, params, obstacles, free_cells_inv, device) -> None:
        device = torch.device(device)
        lib = None if device.type == "cpu" else _build.load_library()
        super().__init__(params, obstacles, free_cells_inv, device)
        self._consts = step_params(params, free_cells_inv)
        n_partials = 0
        if lib is not None:
            n_partials = lib.lbm_num_partials(params.ny, params.nx)
            if n_partials < 0:
                raise ValueError(
                    f"grid {params.ny}x{params.nx} exceeds the kernel's launch limits"
                )
        self.register_buffer(
            "partials", torch.empty(n_partials, dtype=torch.float32, device=device)
        )

    def forward(self, f_in, f_out, av, t) -> None:
        if f_in.device.type == "cpu":
            self._plain_into(f_in, f_out, av, t)
            return
        lib = _build.load_library()
        self._check_cuda(f_in, f_out, av)
        if not 0 <= t < av.numel():
            raise ValueError(f"av index {t} out of range for {av.numel()} steps")
        _launch(lib, f_in.data_ptr(), f_out.data_ptr(), self.fluid.data_ptr(),
                self.partials.data_ptr(), av.data_ptr() + 4 * t,
                ctypes.addressof(self._consts),
                torch.cuda.current_stream(f_in.device).cuda_stream)

    def bind(self, f_a, f_b, av):
        """As :meth:`StepProgram.bind`; for CUDA tensors the buffers are
        checked and their pointers taken here, once, and each ``launch(t)``
        only launches."""
        if f_a.device.type == "cpu":
            return super().bind(f_a, f_b, av)
        lib = _build.load_library()
        self._check_cuda(f_a, f_b, av)
        ptrs = (f_a.data_ptr(), f_b.data_ptr())
        fluid, partials = self.fluid.data_ptr(), self.partials.data_ptr()
        consts = ctypes.addressof(self._consts)
        av0, n = av.data_ptr(), av.numel()
        stream = torch.cuda.current_stream(f_a.device).cuda_stream

        def launch(t: int) -> None:
            if not 0 <= t < n:
                raise ValueError(f"av index {t} out of range for {n} steps")
            _launch(lib, ptrs[t & 1], ptrs[~t & 1], fluid, partials, av0 + 4 * t,
                    consts, stream)

        return launch

    def _check_cuda(self, f_in, f_out, av) -> None:
        shape = (NSPEEDS, self.params.ny, self.params.nx)
        for name, x in (("f_in", f_in), ("f_out", f_out)):
            if x.device.type != "cuda":
                raise ValueError(f"{name} must be a CUDA or CPU tensor, got {x.device}")
            if x.dtype != torch.float32 or tuple(x.shape) != shape:
                raise ValueError(
                    f"{name} must be float32 {shape}, got {x.dtype} {tuple(x.shape)}"
                )
            if not x.is_contiguous() or x.device != self.fluid.device:
                raise ValueError(f"{name} must be contiguous on {self.fluid.device}")
        if f_in.data_ptr() == f_out.data_ptr():
            raise ValueError("f_in and f_out must be distinct buffers (ping-pong)")
        if (
            av.dtype != torch.float32
            or av.device != self.fluid.device
            or not av.is_contiguous()
        ):
            raise ValueError(
                f"av must be a contiguous float32 vector on {self.fluid.device}"
            )
        if self.fluid.device.index != torch.cuda.current_device():
            raise ValueError(
                f"launch on {self.fluid.device} needs it to be the current "
                f"CUDA device (now cuda:{torch.cuda.current_device()})"
            )

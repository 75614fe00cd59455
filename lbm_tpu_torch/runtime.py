"""Host runtime: device selection, the step program, and the time loop.

The port of ``lbm_tpu.runtime`` (single device).  The reference enqueues
``maxIters`` asynchronous kernel launches and syncs once at the end
(``d2q9-bgk.c:221-240``); so does :meth:`Simulator.run`: it initialises f
on the device, enqueues the step program's launches (one per step, per
chunk of steps or per temporal pass, as :mod:`lbm_tpu_torch.ops.schedule`
chose for the run's length) with the per-step mean speed kept in a device
vector, and reads back once.  On the graph route (:mod:`lbm_tpu_torch.graphs`,
chosen by topology: one device, no ``nan_guard``) those launches were
captured into CUDA graphs before the timer, as ``lbm_tpu`` compiles its
``lax.scan`` before it, and the run replays them; on the eager route each
launch is a call from Python.  A Simulator keeps each run it compiled, and
a later run of the same length, readback and route reuses it
(:meth:`Simulator.compiled`), as ``lbm_tpu`` keeps its executables.
:meth:`Simulator.run_checkpointed` runs in segments and snapshots after
each (``lbm_tpu.checkpoint``'s files, so either package resumes the
other's run).  While a ``torch.profiler``
records, a run's stages are spans (:func:`lbm_tpu_torch.utils.profiling.span`):
``runtime.run`` around ``runtime.prepare`` (its ``reused``: 1 where the
run was kept, 0 where it was made, with ``runtime.program``,
``runtime.alloc`` and ``graphs.capture``), ``runtime.launch``
(``graphs.replay``), ``runtime.sync``, ``runtime.readback`` and
``runtime.expand`` (:func:`expand_fields`; its ``device``: 1 where the card
reconstructed the fields, 0 where the host did).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time
import types
from typing import Any, Callable

import numpy as np
import torch

from lbm_tpu_torch import checkpoint as ckpt
from lbm_tpu_torch import diagnostics, graphs, tuning
from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.geometry import free_cells_of
from lbm_tpu_torch.ops import _build
from lbm_tpu_torch.ops.fused import BandCarry, MegaStep, ReferenceStep, StepProgram
from lbm_tpu_torch.ops.reference import init_cells, uniform_weights
from lbm_tpu_torch.ops.schedule import choose_temporal, make_fused_program
from lbm_tpu_torch.utils import debugging, profiling
from lbm_tpu_torch.utils.profiling import BYTES_PER_CELL

# "state"  — fetch the 9 f-planes to host.
# "fields" — the compact float16 [u_x, u_y, rho - density] payload,
#            reconstructed to [u_x, u_y, |u|, pressure] (expand_fields): on
#            a CUDA device by a kernel, and that fetched; on the CPU device
#            the payload fetched and reconstructed by numpy.
# "device" — return f as the on-device tensor, no fetch (av_vels is still
#            fetched, and that fetch is the sync point the timer stops on).
READBACK_MODES = ("state", "fields", "device")
KERNELS = ("auto", "fused", "temporal", "mega", "reference")

# Peak device bytes of a state-readback run, in units of f's bytes: the two
# ping-pong f buffers plus the uint8 mask (1 B per cell, 1/36 of f).  The
# readback copies the final buffer straight to the host, so it adds nothing
# on the device.
_STATE_READBACK_PEAK_FACTOR = 2.0 + 1.0 / 36.0
# Headroom left for the allocator, the CUDA context and the av vector.
_BUDGET_SHARE = 15.0 / 16.0
# Device bytes a cell of the card's reconstruction writes: four float32
# planes.  Where the whole grid's do not fit the budget beside what the
# device holds, the reconstruction goes by slabs of rows of about
# _EXPAND_SLAB_BYTES (expand_rows).
_EXPAND_BYTES_PER_CELL = 16
_EXPAND_SLAB_BYTES = 1 << 28


def hbm_budget_gib(device: torch.device) -> float:
    """Device-memory budget for :func:`state_readback_fits`: 15/16 of the
    CUDA device's total memory (``torch.cuda.mem_get_info``), or of the
    host's physical memory for a CPU device."""
    if device.type == "cuda":
        _, total = torch.cuda.mem_get_info(device)
    else:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return total / 2**30 * _BUDGET_SHARE


def state_readback_fits(ny: int, nx: int, budget_gib: float) -> bool:
    """Whether a state-readback run's peak device footprint fits
    ``budget_gib`` (see the factor's derivation above)."""
    f_gib = 9 * ny * nx * 4 / 2**30
    return _STATE_READBACK_PEAK_FACTOR * f_gib <= budget_gib


def raw_fields_fn(params: LBMParams):
    """Device-side ``(f, fluid) -> [u_x, u_y, rho - density]`` in float16 —
    the compact fields-readback payload of ``lbm_tpu.runtime.raw_fields_fn``:
    |u| and pressure are derived from it (:func:`expand_fields`), and
    rho is delta-encoded against the nominal density, so the fp16 quantum
    bounds the pressure error at ~0.003%, far inside the 1% protocol.
    u is masked to 0 on obstacle cells (``d2q9-bgk.c:789-836``).  rho is
    summed left to right, as the step sums it: ``torch.sum`` over the 9
    planes associates differently with the tensor's shape, so a shard's
    fields would not be the bits of the same cells of the whole grid."""
    density = float(np.float32(params.density))

    def fields(f: torch.Tensor, fluid: torch.Tensor) -> torch.Tensor:
        rho = functools.reduce(torch.add, f.unbind(0))
        zero = torch.zeros_like(rho)
        ux = torch.where(fluid, (f[1] + f[5] + f[8] - f[3] - f[6] - f[7]) / rho, zero)
        uy = torch.where(fluid, (f[2] + f[5] + f[6] - f[4] - f[7] - f[8]) / rho, zero)
        return torch.stack([ux, uy, rho - density]).to(torch.float16)

    return fields


def expand_fields(
    raw: np.ndarray | torch.Tensor, obstacles: np.ndarray, density: float
) -> np.ndarray:
    """``[u_x, u_y, rho - density] -> [u_x, u_y, |u|, pressure]`` (the
    complete ``final_state.dat`` payload; obstacle cells get u = 0 and
    pressure = density/3), reconstructed in fp64 and rounded to fp32, as a
    host float32 ``[4, ny, nx]`` array the caller owns.  A CUDA tensor
    ``raw`` is reconstructed on its card (:func:`_expand_on_card`) and the
    result copied to the host; a host array or CPU tensor by numpy
    (:func:`_expand_on_host`).  Both give the same bits.  The span
    ``runtime.expand`` counts ``device``: 1 on the card, 0 on the host."""
    on_card = isinstance(raw, torch.Tensor) and raw.device.type == "cuda"
    with profiling.span("runtime.expand", device=int(on_card)):
        if on_card:
            return _expand_on_card(raw, obstacles, density)
        return _expand_on_host(raw, obstacles, density)


def _expand_on_host(raw, obstacles: np.ndarray, density: float) -> np.ndarray:
    """:func:`expand_fields` in numpy: ``lbm_tpu.runtime.expand_fields``."""
    fluid = ~np.asarray(obstacles, dtype=bool)
    ux = np.asarray(raw[0], dtype=np.float64)
    uy = np.asarray(raw[1], dtype=np.float64)
    rho = float(np.float32(density)) + np.asarray(raw[2], dtype=np.float64)
    speed = np.sqrt(ux * ux + uy * uy)
    pressure = np.where(fluid, rho / 3.0, density / 3.0)
    return np.stack([ux, uy, speed, pressure]).astype(np.float32)


def expand_rows(ny: int, nx: int, held_bytes: int, budget_bytes: float) -> int:
    """Rows of a slab of the card's reconstruction: all ``ny`` where the
    whole grid's output fits ``budget_bytes`` beside ``held_bytes``, else
    about ``_EXPAND_SLAB_BYTES`` of rows (at least one)."""
    row_bytes = _EXPAND_BYTES_PER_CELL * nx
    if held_bytes + row_bytes * ny <= budget_bytes:
        return ny
    return max(1, min(ny, _EXPAND_SLAB_BYTES // row_bytes))


def _expand_on_card(raw: torch.Tensor, obstacles: np.ndarray, density: float,
                    rows: int | None = None) -> np.ndarray:
    """:func:`expand_fields` by ``lbm_expand_fields`` (``csrc/lbm_expand.cu``)
    on ``raw``'s card, slab by slab of ``rows`` rows into one device buffer,
    each slab copied to its rows of the host array before the next: one slab,
    the whole grid, where :func:`expand_rows` admits it beside what the
    device's allocator holds within :func:`hbm_budget_gib`."""
    if raw.dtype != torch.float16 or raw.dim() != 3 or raw.shape[0] != 3:
        raise ValueError(f"raw must be a float16 [3, ny, nx] tensor, got "
                         f"{raw.dtype} {tuple(raw.shape)}")
    _, ny, nx = raw.shape
    mask = np.ascontiguousarray(obstacles, dtype=bool)
    if mask.shape != (ny, nx):
        raise ValueError(f"obstacle mask {mask.shape} != grid {(ny, nx)}")
    device = raw.device
    lib = _build.load_library()
    with torch.cuda.device(device):
        raw = raw.contiguous()
        mask = torch.from_numpy(mask.view(np.uint8)).to(device)
        if rows is None:
            rows = expand_rows(ny, nx, torch.cuda.memory_allocated(device),
                               hbm_budget_gib(device) * 2**30)
        rows = min(rows, ny)
        out = torch.empty((4, rows, nx), dtype=torch.float32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        cells = ny * nx

        def expand(row0: int, n: int) -> None:
            rc = lib.lbm_expand_fields(raw.data_ptr() + 2 * row0 * nx, cells,
                                       mask.data_ptr() + row0 * nx, n * nx,
                                       out.data_ptr(), rows * nx,
                                       float(np.float32(density)), float(density), stream)
            if rc != 0:
                raise RuntimeError("lbm_expand_fields launch failed: "
                                   f"{lib.lbm_error_string(rc).decode()}")

        host = np.empty((4, ny, nx), dtype=np.float32)
        planes = torch.from_numpy(host)
        for row0 in range(0, ny, rows):
            n = min(rows, ny - row0)
            expand(row0, n)
            planes[:, row0:row0 + n].copy_(out[:, :n])
        return host


def check_readback(readback: str) -> None:
    if readback not in READBACK_MODES:
        raise ValueError(
            f"readback must be one of {READBACK_MODES}, got {readback!r}"
        )


def select_device(spec: str | int | None = None) -> torch.device:
    """Pick the compute device from ``spec`` or ``LBM_DEVICE``: an integer
    is a CUDA index, ``cpu`` selects the CPU (the plain torch path), and
    unset means CUDA device 0.  Without CUDA, anything but ``cpu`` raises:
    there is no silent CPU default."""
    if spec is None:
        spec = os.environ.get("LBM_DEVICE", "")
    spec = str(spec).strip()
    if spec.lower() == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; set LBM_DEVICE=cpu to run the "
            "plain torch path on the CPU"
        )
    try:
        idx = int(spec) if spec else 0
    except ValueError:
        raise ValueError(
            f"LBM_DEVICE must be a CUDA index or 'cpu', got {spec!r}"
        ) from None
    count = torch.cuda.device_count()
    if not 0 <= idx < count:
        raise ValueError(f"LBM_DEVICE={idx} out of range; {count} CUDA device(s)")
    return torch.device("cuda", idx)


def make_program(
    params: LBMParams,
    obstacles: np.ndarray,
    free_cells_inv: np.float32,
    kernel: str,
    device: torch.device,
    max_iters: int | None = None,
) -> StepProgram:
    """Step-program factory.  'auto' is the kernel schedule of
    ``lbm_tpu``'s ``make_fused_program`` for ``max_iters`` steps (the
    multi-step, temporal or one-step kernel, or the x-tiled one where a
    state-readback run of the grid does not fit :func:`hbm_budget_gib`;
    their plain versions on CPU tensors); 'fused' and 'temporal' are
    other names for it, kept so that
    ``lbm_tpu`` command lines run unchanged ('temporal' is ``lbm_tpu``'s
    single-device alias of 'fused').  'mega' is the megakernel at the
    temporal tile and K, with the largest T <= 25 passes per launch that
    divides ``max_iters``, and 'auto' where there is no such split
    (``lbm_tpu.runtime.make_program``).  'reference' is the plain torch
    step on any device, and is never chosen implicitly.  The temporal
    tiles come first from the tuning cache of ``device``'s kind
    (:mod:`lbm_tpu_torch.tuning`)."""
    kind = tuning.device_kind(device)
    if kernel == "mega":
        picked = None if max_iters is None else choose_temporal(
            params.ny, params.nx, max_iters, kind)
        if picked is not None:
            by, bx, ksteps = picked
            tpasses = next((t for t in range(25, 0, -1)
                            if max_iters % (t * ksteps) == 0), None)
            if tpasses is not None:
                return MegaStep(params, obstacles, free_cells_inv, device, by, bx,
                                ksteps, tpasses)
        kernel = "auto"
    if kernel in ("auto", "fused", "temporal"):
        return make_fused_program(
            params, obstacles, free_cells_inv, device, max_iters=max_iters,
            pingpong_fits=state_readback_fits(params.ny, params.nx,
                                              hbm_budget_gib(device)),
            device_kind=kind,
        )
    if kernel == "reference":
        return ReferenceStep(params, obstacles, free_cells_inv, device)
    raise ValueError(f"unknown kernel {kernel!r}; expected one of {KERNELS}")


@dataclasses.dataclass
class RunResult(diagnostics.ResultMetrics):
    """Outcome of a full simulation run.

    Exactly one of ``f`` (readback "state": the 9 distribution planes as a
    numpy array; "device": the on-device tensor) or ``fields``
    (readback "fields": ``[u_x, u_y, |u|, pressure]``) is set.
    """

    params: LBMParams
    f: np.ndarray | torch.Tensor | None  # [9, ny, nx] float32
    av_vels: np.ndarray  # [max_iters] float32 per-step mean fluid speed
    obstacles: np.ndarray  # [ny, nx] bool
    free_cells_inv: float
    elapsed: float  # seconds: init, step loop and readback
    fields: np.ndarray | None = None  # [4, ny, nx] float32
    steps_timed: int | None = None
    # Timesteps per kernel launch of the program that ran, and its
    # device-memory bytes per cell update (for bandwidth accounting).
    steps_per_pass: int = 1
    bytes_per_update: float = float(BYTES_PER_CELL)


class Simulator:
    """One configured simulation: grid, obstacles, device, step program."""

    def __init__(
        self,
        params: LBMParams,
        obstacles: np.ndarray,
        *,
        kernel: str = "auto",
        device: torch.device | str | None = None,
    ) -> None:
        obstacles = np.asarray(obstacles, dtype=bool)
        if obstacles.shape != (params.ny, params.nx):
            raise ValueError(
                f"obstacle mask {obstacles.shape} != grid {(params.ny, params.nx)}"
            )
        self.params = params
        self.obstacles = obstacles
        self.free_cells = free_cells_of(obstacles)
        self.free_cells_inv = np.float32(1.0) / np.float32(self.free_cells)
        self.device = torch.device(device) if device is not None else select_device()
        self.kernel = kernel
        if kernel not in KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}; expected one of {KERNELS}")
        # Builds the CUDA kernels here, before any timer.
        if self.device.type != "cpu" and kernel != "reference":
            _build.load_library()
        self._programs: dict[int | None, StepProgram] = {}
        # The compiled runs (:meth:`compiled`) and the f buffers they share.
        self._runs: dict[tuple[int, str, str], Callable] = {}
        self._buffers: list[torch.Tensor] = []
        self._fields = raw_fields_fn(params)

    @property
    def program(self) -> StepProgram:
        """The step program of a run of ``params.max_iters`` steps."""
        return self.program_for(self.params.max_iters)

    def program_for(self, max_iters: int | None) -> StepProgram:
        """The step program chosen for a run of ``max_iters`` steps (made
        once per length, with the mask uploaded, outside any timer)."""
        if max_iters not in self._programs:
            with profiling.span("runtime.program"):
                self._programs[max_iters] = make_program(
                    self.params, self.obstacles, self.free_cells_inv, self.kernel,
                    self.device, max_iters=max_iters,
                )
        return self._programs[max_iters]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def launch_route(self, route: str | None = None) -> str:
        """How a run's launches are made (:mod:`lbm_tpu_torch.graphs`):
        ``route`` where given (``"graph"`` or ``"eager"``, to compare the
        two), else by topology, :func:`graphs.choose_route` (one device:
        ``"graph"``, but ``"eager"`` inside ``nan_guard`` and for the plain
        torch step on a CUDA device)."""
        if route is not None:
            return graphs.check_route(route)
        return graphs.choose_route([self.device], plain=self.kernel == "reference")

    def compiled(self, max_iters: int | None = None, readback: str = "state",
                 route: str | None = None):
        """Validate the run configuration and return the untimed part of a
        run, ``fn(f0) -> (out, av)`` on the device (``f0`` None = the
        uniform initial state), whose ``route`` names the route
        (:meth:`launch_route`); call it through :meth:`run`, which times it.

        A run is compiled once per ``(max_iters, readback, route)``
        (``"device"`` shares ``"state"``'s run), as ``lbm_tpu`` keeps its
        executables, and a later call returns the same ``fn`` having made
        nothing.  The first call chooses the step program for ``max_iters``
        steps (the kernels were built when the Simulator was made),
        allocates the av vector, and on the graph route captures the
        launches (:class:`graphs.GraphRunner`, at the ``graphs.PERIOD`` of
        that call).  Every run of one Simulator binds the same f buffers
        (``fn.buffers``: the ping-pong pair, or the first of them for an
        in-place program), so device memory holds one state however many
        runs are kept; runs on one Simulator are sequential.  A capture
        that fails raises."""
        with profiling.span("runtime.prepare") as prepare:
            check_readback(readback)
            route = self.launch_route(route)
            if max_iters is None:
                max_iters = self.params.max_iters
            key = (max_iters, "state" if readback == "device" else readback, route)
            fn = self._runs.get(key)
            prepare.set(reused=int(fn is not None))
            if fn is None:
                fn = self._runs[key] = self._compile(max_iters, readback == "fields", route)
            return fn

    def _compile(self, max_iters: int, fields: bool, route: str):
        """The run of :meth:`compiled`, made.  ``fn`` holds nothing that
        holds the Simulator, so dropping the Simulator frees its buffers
        and graphs at once."""
        program = self.program_for(max_iters)  # its chunk divides max_iters
        launches, chunk = max_iters // program.chunk, program.chunk
        shape = (9, self.params.ny, self.params.nx)
        with profiling.span("runtime.alloc"):
            self._buffers += [torch.empty(shape, dtype=torch.float32, device=self.device)
                              for _ in range(program.n_buffers - len(self._buffers))]
            bufs = self._buffers[:program.n_buffers]
            av = torch.zeros(max_iters, dtype=torch.float32, device=self.device)
        uniform = self._uniform()
        to_fields, fluid = (self._fields, program.fluid.bool()) if fields else (None, None)
        runner = None
        if route == "graph":
            carry = program.init(bufs[0]) if program.n_buffers == 1 else None

            def bind(scratch):
                return (program.bind(*bufs, scratch[0]) if carry is None
                        else program.bind_carry(carry, scratch[0]))

            with self._guard():
                runner = graphs.GraphRunner(bind, launches, chunk, [av],
                                            graphs.capture_for(self.device))

        def fn(f0=None):
            if f0 is not None and tuple(f0.shape) != shape:
                raise ValueError(f"f0 must be {shape}, got {tuple(f0.shape)}")
            bufs[0].copy_(uniform if f0 is None else torch.as_tensor(f0))
            if runner is not None:
                runner.run([av])
            else:
                launch = debugging.guarded(program.bind(*bufs, av), lambda i: (
                    ("f", bufs[program.final_index(i + 1)]),
                    ("av", av[i * chunk:(i + 1) * chunk])))
                for i in range(launches):
                    launch(i)
            out = bufs[program.final_index(launches)]
            if to_fields is not None:
                return to_fields(out, fluid), av
            return out, av

        fn.route, fn.buffers = route, bufs
        return fn

    def _uniform(self) -> torch.Tensor:
        """The uniform initial state as a broadcast view (no f-sized
        tensor behind it)."""
        w = torch.as_tensor(uniform_weights(self.params), device=self.device)
        return w[:, None, None].expand(9, self.params.ny, self.params.nx)

    def _guard(self):
        return (torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())

    def initial_state(self) -> torch.Tensor:
        """The uniform initial state on the device."""
        return init_cells(self.params, self.device)

    def step_fn(self):
        """The single-step function ``f -> (f', av)``: the one-step program
        (``max_iters`` unknown), as ``lbm_tpu.runtime.make_step`` has it."""
        return self.program_for(None).single

    def run(
        self,
        max_iters: int | None = None,
        f0: np.ndarray | torch.Tensor | None = None,
        readback: str = "state",
        route: str | None = None,
    ) -> RunResult:
        """Initialise, run the time loop on the device, read back once.

        The timed region is the initialisation (or the upload of ``f0``),
        the step loop (on the graph route the replays) and the readback:
        the reference's tic..toc, which excludes context creation, the
        kernel build and the capture (:meth:`compiled`, made once for
        every run of one length, readback and route).  In "fields" mode
        |u| and pressure are reconstructed (:func:`expand_fields`) on a
        CUDA device by a kernel before the timer stops, which then holds
        the copy of the four float32 planes, and on the CPU device by
        numpy after it; in "device" mode ``f`` is a copy of the run's
        buffer, which the next run rewrites.  ``route`` forces a route
        (:meth:`launch_route`)."""
        if max_iters is None:
            max_iters = self.params.max_iters
        with profiling.span("runtime.run"):
            fn = self.compiled(max_iters, readback=readback, route=route)
            program = self.program_for(max_iters)
            self._sync()
            tic = time.perf_counter()
            with self._guard(), profiling.span("runtime.launch"):
                out, av = fn(f0)
                if readback == "device":
                    # The next run rewrites the Simulator's f buffers: hand
                    # back a copy, made before the sync the timer stops on.
                    out = out.clone()
            # Copies on the CPU device too, where .cpu() would hand back the
            # kept run's own av and buffers.
            with profiling.span("runtime.sync"):
                av_host = av.to("cpu", copy=True).numpy()
            # On a card the fields are reconstructed there, inside the timer.
            expanded = readback == "fields" and out.device.type == "cuda"
            if readback == "device":
                out_host = out
            elif expanded:
                out_host = expand_fields(out, self.obstacles, self.params.density)
            else:
                with profiling.span("runtime.readback"):
                    out_host = out.to("cpu", copy=True).numpy()
            toc = time.perf_counter()
            if readback == "fields" and not expanded:
                out_host = expand_fields(out_host, self.obstacles, self.params.density)
            return RunResult(
                params=dataclasses.replace(self.params, max_iters=max_iters),
                f=None if readback == "fields" else out_host,
                fields=out_host if readback == "fields" else None,
                av_vels=av_host,
                obstacles=self.obstacles,
                free_cells_inv=float(self.free_cells_inv),
                elapsed=toc - tic,
                steps_timed=max_iters,
                steps_per_pass=program.chunk,
                bytes_per_update=program.bytes_per_update,
            )

    def run_checkpointed(
        self,
        checkpoint_dir: str,
        every: int,
        max_iters: int | None = None,
        resume: bool = True,
        route: str | None = None,
    ) -> RunResult:
        """Run in ``every``-step segments, snapshotting the resumable state
        (f, step index, av_vels so far) after each segment; picks up from
        a checkpoint in ``checkpoint_dir`` when ``resume``
        (``lbm_tpu.runtime.Simulator.run_checkpointed``).

        Where a state readback of the grid does not fit the device budget
        and the program has checkpoint hooks (the x-tiled program, which
        :func:`make_program` picks for such a grid where the gate admits
        it), the carry stays on the device between segments
        (:meth:`_run_checkpointed_carry`); else f does, each segment a
        ``readback="device"`` run, and only a snapshot copies it to the
        host.  Each segment length is compiled before the timer
        (:meth:`compiled`), and its run (on the graph route its graphs)
        reused for every segment of that length."""
        if max_iters is None:
            max_iters = self.params.max_iters
        route = self.launch_route(route)
        if not state_readback_fits(self.params.ny, self.params.nx,
                                   hbm_budget_gib(self.device)):
            program = self.program_for(min(every, max_iters) or None)
            if program.checkpoint_io is not None:
                return self._run_checkpointed_carry(
                    program, checkpoint_dir, every, max_iters, resume, route)

        def precompile(seg: int) -> None:
            self.compiled(seg, readback="device", route=route)

        def run_segment(seg, f0):
            # A fresh start seeds f0 from the uniform state, so every
            # segment runs the same way.
            fn = self.compiled(seg, readback="device", route=route)
            with self._guard():
                out, av = fn(f0 if f0 is not None else self._uniform())
                # The next segment of this length rewrites av: keep a copy.
                return types.SimpleNamespace(f=out, av_vels=av.to("cpu", copy=True).numpy())

        f, av, elapsed, executed = run_segments_checkpointed(
            run_segment=run_segment,
            precompile=precompile,
            params=self.params,
            obstacles=self.obstacles,
            checkpoint_dir=checkpoint_dir,
            every=every,
            max_iters=max_iters,
            resume=resume,
            # A segment's f is the on-device tensor: a snapshot copies it.
            save_fn=lambda d, params, obstacles, step, f, av: ckpt.save(
                d, params, obstacles, step, f.cpu().numpy(), av),
        )
        if f is None:  # zero remaining work and nothing checkpointed
            return self.run(max_iters=0)
        if not isinstance(f, np.ndarray):
            # The snapshot committed just above holds exactly this state:
            # read it back from disk, as lbm_tpu does.
            f = ckpt.load(checkpoint_dir).f
        program = self.program_for(min(every, executed)) if executed else None
        return RunResult(
            params=dataclasses.replace(self.params, max_iters=max_iters),
            f=np.asarray(f),
            av_vels=av,
            obstacles=self.obstacles,
            free_cells_inv=float(self.free_cells_inv),
            elapsed=elapsed,
            steps_timed=executed,
            steps_per_pass=program.chunk if program is not None else 1,
            bytes_per_update=(program.bytes_per_update if program is not None
                              else float(BYTES_PER_CELL)),
        )

    def _run_checkpointed_carry(
        self,
        program: StepProgram,
        checkpoint_dir: str,
        every: int,
        max_iters: int,
        resume: bool,
        route: str,
    ) -> RunResult:
        """Carry-resident checkpointed segments for giant grids: the one f
        buffer and its bands stay on the device between segments (no
        second f-sized buffer per segment), and snapshots and resume
        convert carry <-> f on the host through ``program.checkpoint_io``,
        in the portable v1 f-format.  On the graph route the run has one
        carry, made before the timer, and one :class:`graphs.GraphRunner`
        a segment length, reused for every segment of that length; each
        graph starts by filling the bands from f (the launch's prologue),
        so a resume uploads f alone."""
        io = program.checkpoint_io
        k = program.chunk
        runners: dict[int, graphs.GraphRunner] = {}
        held: list[BandCarry] = []

        def check_segment(seg: int) -> None:
            if seg % k != 0:
                raise ValueError(
                    f"carry-resident checkpoint segments must be multiples "
                    f"of the giant-grid schedule's {k}-step chunk, got a "
                    f"{seg}-step segment.  It comes from `every`, the "
                    f"remainder to max_iters, or the tail after resuming a "
                    f"checkpoint whose step offset is not {k}-aligned (a "
                    f"snapshot written by a different kernel or program) — "
                    f"align all three to {k}"
                )

        def precompile(seg: int) -> None:
            check_segment(seg)
            if route != "graph":
                return
            with self._guard():
                if not held:
                    f = torch.empty(9, self.params.ny, self.params.nx,
                                    dtype=torch.float32, device=self.device)
                    held.append(program.init(f))
                carry = held[0]
                runners[seg] = graphs.GraphRunner(
                    lambda scratch: program.bind_carry(carry, scratch[0]), seg // k, k,
                    [carry.f], graphs.capture_for(self.device))

        def run_graphs(seg, c0):
            carry = held[0]
            with self._guard():
                if c0 is None:
                    carry.f.copy_(self._uniform())
                elif isinstance(c0, np.ndarray):  # resumed snapshot (host f)
                    carry.f.copy_(torch.from_numpy(np.asarray(c0, dtype=np.float32)))
                av = torch.empty(seg, dtype=torch.float32, device=self.device)
                runners[seg].run([av])
                return types.SimpleNamespace(f=carry, av_vels=av.cpu().numpy())

        def run_segment(seg, c0):
            if route == "graph":
                return run_graphs(seg, c0)
            check_segment(seg)
            with self._guard():
                if c0 is None:
                    f = torch.empty(9, self.params.ny, self.params.nx,
                                    dtype=torch.float32, device=self.device)
                    carry = program.init(f.copy_(self._uniform()))
                elif isinstance(c0, np.ndarray):  # resumed snapshot (host f)
                    carry = io.from_f_host(c0)
                else:  # the previous segment's carry
                    carry = c0
                av = torch.empty(seg, dtype=torch.float32, device=self.device)
                launch = program.bind_carry(carry, av)
                for i in range(seg // k):
                    launch(i)
                return types.SimpleNamespace(f=carry, av_vels=av.cpu().numpy())

        last_snap: dict[str, Any] = {}

        def save_carry(dirname, params, obstacles, step, carry, av):
            f_host = io.to_f_host(carry)
            # The segment loop snapshots after the last segment, so the final
            # RunResult.f reuses this host copy.
            last_snap["step"], last_snap["f"] = step, f_host
            ckpt.save(dirname, params, obstacles, step, f_host, av)

        state, av, elapsed, executed = run_segments_checkpointed(
            run_segment=run_segment,
            precompile=precompile,
            params=self.params,
            obstacles=self.obstacles,
            checkpoint_dir=checkpoint_dir,
            every=every,
            max_iters=max_iters,
            resume=resume,
            save_fn=save_carry,
        )
        if state is None:  # max_iters == 0 and nothing checkpointed
            f_host = init_cells(self.params).numpy()
        elif isinstance(state, np.ndarray):  # resume found a complete run
            f_host = state
        elif last_snap.get("step") == max_iters:
            f_host = last_snap["f"]
        else:
            f_host = io.to_f_host(state)
        return RunResult(
            params=dataclasses.replace(self.params, max_iters=max_iters),
            f=f_host,
            av_vels=av,
            obstacles=self.obstacles,
            free_cells_inv=float(self.free_cells_inv),
            elapsed=elapsed,
            steps_timed=executed,
            steps_per_pass=k,
            bytes_per_update=program.bytes_per_update,
        )


def run_segments_checkpointed(
    *,
    run_segment: Callable[[int, Any], Any],
    precompile: Callable[[int], Any],
    params: LBMParams,
    obstacles: np.ndarray,
    checkpoint_dir: str,
    every: int,
    max_iters: int,
    resume: bool,
    save_fn: Callable[..., Any],
) -> tuple[Any, np.ndarray, float, int]:
    """The checkpointed-segment loop (``lbm_tpu.runtime
    .run_segments_checkpointed``).

    ``run_segment(seg, state)`` returns an object with ``.f`` (the state
    for the next segment: an on-device tensor or carry) and ``.av_vels``;
    ``state`` is None for a fresh start or the snapshot's host f after a
    resume.  Returns ``(state_final, av_vels, elapsed, steps_executed)``
    with ``state_final`` None when there was no work at all.
    ``steps_executed`` counts only THIS invocation's steps (a resume does
    not re-run the checkpointed prefix): perf figures must use it, not
    ``max_iters``.  ``save_fn(dir, params, obstacles, step, f, av)`` writes
    each snapshot from the segment's ``.f``."""
    if every <= 0:
        raise ValueError(f"checkpoint interval must be positive: {every}")

    start = 0
    av_parts: list[np.ndarray] = []
    f = None
    if resume:
        loaded = ckpt.load(checkpoint_dir)
        if loaded is not None:
            loaded.validate(params, obstacles)
            if loaded.step > max_iters:
                raise ValueError(
                    f"checkpoint at step {loaded.step} is beyond "
                    f"max_iters={max_iters}"
                )
            start = loaded.step
            av_parts.append(np.asarray(loaded.av_vels))
            f = loaded.f

    # Prepare every distinct segment length (at most two: ``every`` and the
    # final remainder) before the timer.
    remaining = max_iters - start
    if remaining >= every:
        precompile(every)
    tail = remaining % every if remaining >= every else remaining
    if tail:
        precompile(tail)

    tic = time.perf_counter()
    step = start
    while step < max_iters:
        seg = min(every, max_iters - step)
        res = run_segment(seg, f)
        f = res.f
        av_parts.append(res.av_vels)
        step += seg
        save_fn(
            checkpoint_dir,
            params,
            obstacles,
            step,
            f,
            np.concatenate(av_parts) if av_parts else np.zeros(0),
        )
    elapsed = time.perf_counter() - tic

    av = (
        np.concatenate(av_parts) if av_parts else np.zeros(0, dtype=np.float32)
    )
    return f, av, elapsed, max_iters - start

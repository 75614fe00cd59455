"""The step programs: hand-written CUDA kernels and their plain torch
versions.

Ports of ``lbm_tpu.ops.fused``'s Pallas programs:

* :class:`FusedStep` — one step per launch (``_step_kernel_single`` and
  ``_step_kernel_blocked``, ``build_fused_program``); ``csrc/lbm_step.cu``.
* :class:`MultiStep` — ``chunk`` steps per launch with the whole grid
  resident (``_step_kernel_multi``, ``build_multi_step_program``): in
  bands of rows in shared memory across the card's SMs,
  ``csrc/lbm_multi_bands.cu``, or with a grid barrier,
  ``csrc/lbm_multi.cu``, whichever the route takes.
* :class:`TemporalStep` — K steps per pass on 2-D tiles
  (``_step_kernel_temporal``, ``build_temporal_program``);
  ``csrc/lbm_temporal.cu``, and with f stored in 16 bits (its
  ``storage=`` float16 or bfloat16) ``csrc/lbm_temporal16.cu``.
* :class:`TemporalXtStep` — K steps per pass on 2-D tiles of ONE f
  buffer updated in place, the halo from carried bands
  (``_step_kernel_temporal_xt``, ``build_temporal_xtiled_program``: the
  giant-grid schedule); ``csrc/lbm_temporal_xt.cu``.
* :class:`MegaStep` — T such passes in one cooperative launch
  (``_step_kernel_mega``, ``build_mega_program``); the same source.
* :class:`ShardStep` — one step of one shard of a sharded run, on its
  halo-padded tile (``_step_kernel_blocked_gated``, as the sharded
  factories build it); ``csrc/lbm_shard.cu``.
* :class:`ShardTemporalStep` — K steps per pass of one shard, on its tile
  padded by K cells (``_step_kernel_temporal`` as the sharded temporal
  factories use it); the shard entry of ``csrc/lbm_temporal.cu``.
* :class:`ShardTemporalXtStep` — one in-place pass of one shard's row
  slab, the y halo from a ghost buffer the neighbours fill
  (``_step_kernel_temporal_xt`` as ``make_sharded_temporal_xt_run`` uses
  it); the shard entry of ``csrc/lbm_temporal_xt.cu``.

Each step is body-force kick of row ny-2, pull-stream with periodic wrap,
BGK with bounce-back, and the mean |u| over fluid cells; the kernels share
the per-cell update (``csrc/lbm_cell.cuh``) and each source's head note
says how it is laid out.  :mod:`lbm_tpu_torch.ops.schedule` picks one of
them for a run, as ``lbm_tpu``'s ``make_fused_program`` does.

The program contract, as ``lbm_tpu.ops.fused.StepProgram`` has it: a
program advances ``chunk`` steps per launch.  A run binds its two
ping-pong buffers and ``av`` once (``launch = program.bind(f_a, f_b,
av)``), which checks them once; ``launch(i)`` then advances steps
``[i*chunk, (i+1)*chunk)`` and writes ``av`` over the same range.  After
``n`` launches from ``f_a`` the state is in ``(f_a, f_b)[
program.final_index(n)]``: the one-step and multi-step kernels flip
buffers once per step, the temporal kernel once per pass.  The in-place
programs bind one buffer (``n_buffers == 1``: ``program.bind(f, av)``)
and the state stays in it.  A shard program (:class:`ShardProgram`) keeps
the contract for one shard's padded buffers, and writes the shard's
unscaled |u| sums, which the sharded run adds over the shards.

Every wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors, and for nothing else: on any other device it
launches or raises.  :class:`ReferenceStep` runs the plain one-step on any
device (``kernel="reference"``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import numpy as np
import torch

from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.ops import _build
from lbm_tpu_torch.ops.lattice import CX, CY, NSPEEDS, WEIGHTS, kick_scale
from lbm_tpu_torch.ops.reference import (
    accel_weights,
    accelerate_masked,
    collide,
    kick_scales,
    macroscopic,
    make_masked_step_fn,
    stream_with_ghosts,
)
from lbm_tpu_torch.parallel.halo import TileLayout
from lbm_tpu_torch.utils import debugging
from lbm_tpu_torch.utils.profiling import BYTES_PER_CELL

# Kernel launches, by kernel: each wrapper adds one where it launches its
# kernel (plain-torch steps on the CPU do not count).  A run that went
# through a kernel shows it here.
LAUNCHES = {"lbm_fused_step": 0, "lbm_multi_step": 0, "lbm_multi_bands_step": 0,
            "lbm_temporal_step": 0,
            "lbm_temporal16_step": 0, "lbm_temporal_xt_step": 0, "lbm_mega_step": 0,
            "lbm_shard_step": 0, "lbm_shard_temporal_step": 0,
            "lbm_shard_temporal_xt_step": 0,
            "lbm_ablate_noop": 0, "lbm_ablate_stream": 0, "lbm_ablate_collide": 0,
            "lbm_roofline_add": 0, "lbm_roofline_fma": 0, "lbm_roofline_mix": 0,
            "lbm_exchange_pack": 0, "lbm_exchange_unpack": 0, "lbm_exchange_copy": 0}


# The launches of ``lbm_multi_bands_step`` that took its one-chunk step
# (:attr:`MultiStep.width` not 0): beside LAUNCHES, not in it, so that each
# key of LAUNCHES stays one kernel's entry; reset with it, and like it
# counted at each replay of a CUDA graph, not at its capture
# (:class:`lbm_tpu_torch.graphs.CudaGraph`).
ONE_CHUNK_LAUNCHES = {"lbm_multi_bands_step": 0}
# The launch counts: each kept as the device's launches.
COUNTS = (LAUNCHES, ONE_CHUNK_LAUNCHES)

# The f storage dtypes of the temporal program (``TemporalStep(storage=)``).
STORAGE_DTYPES = (torch.float32, torch.float16, torch.bfloat16)


def reset_launches() -> None:
    for counts in COUNTS:
        for name in counts:
            counts[name] = 0


def runs_plain(x: torch.Tensor) -> bool:
    """Whether a wrapper given ``x`` runs its plain version: for a CPU
    tensor, and on any device inside ``debugging.interpret_kernels()``;
    else it launches its kernel or raises."""
    return x.device.type == "cpu" or debugging.interpreting()


def _launch(lib, name: str, *args) -> None:
    """``lib.<name>(*args)`` on device pointers; raises on a launch error,
    counts a launch of ``name``."""
    rc = getattr(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {lib.lbm_error_string(rc).decode()}")
    LAUNCHES[name] += 1


class _StepParams(ctypes.Structure):
    """Mirrors ``StepParams`` in ``csrc/lbm_cell.cuh`` field for field."""

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
    """``chunk`` timesteps per launch of one grid and physics
    configuration, run through :meth:`bind`.  Holds the fluid mask (uint8,
    1 = fluid) as a buffer; :meth:`plain` is the functional plain-torch
    step and :meth:`plain_launch` the plain version of one launch."""

    chunk = 1
    # f buffers a run binds: two (ping-pong) or one (in place).
    n_buffers = 2
    # Carry <-> host-f hooks for checkpointed runs (in-place programs).
    checkpoint_io = None
    # Device-memory bytes per cell update (see utils/profiling.py).
    bytes_per_update = float(BYTES_PER_CELL)
    # The dtype of the f buffers a run binds.
    storage = torch.float32

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

    @property
    def f_shape(self) -> tuple[int, int, int]:
        """The shape of the f buffers a run binds."""
        return (NSPEEDS, self.params.ny, self.params.nx)

    def plain(self, f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``f -> (f', av)`` in plain torch, on ``f``'s device."""
        return self._masked(f, self.fluid.bool())

    def plain_launch(self, f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One launch in plain torch: ``f -> (f after chunk steps,
        av[chunk])``; ``chunk`` plain steps in a loop."""
        avs = []
        for _ in range(self.chunk):
            f, a = self.plain(f)
            avs.append(a)
        return f, torch.stack(avs)

    def final_index(self, n_launches: int) -> int:
        """Which of the bound ``(f_a, f_b)`` holds the state after
        ``n_launches`` launches from ``f_a``: one flip per step."""
        return (n_launches * self.chunk) & 1

    def single(self, f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One launch from ``f`` (not modified): ``(f', av)``, with ``av``
        a scalar when ``chunk`` is 1, else a ``[chunk]`` vector."""
        bufs = (f.clone(), torch.empty_like(f))
        av = torch.empty(self.chunk, dtype=torch.float32, device=f.device)
        self.bind(*bufs, av)(0)
        return bufs[self.final_index(1)], (av[0] if self.chunk == 1 else av)

    def bind(self, f_a: torch.Tensor, f_b: torch.Tensor, av: torch.Tensor):
        """``launch(i)`` for a ping-pong run over ``(f_a, f_b)`` in plain
        torch: step ``t`` reads ``f_a`` if ``t`` is even, else ``f_b``, and
        writes ``av[t]``."""
        bufs, chunk, n = (f_a, f_b), self.chunk, av.numel()

        def launch(i: int) -> None:
            self._check_launch(i, n)
            for t in range(i * chunk, (i + 1) * chunk):
                self._plain_into(bufs[t & 1], bufs[~t & 1], av, t)

        return launch

    def _plain_into(self, f_in, f_out, av, t) -> None:
        f_new, a = self.plain(f_in)
        f_out.copy_(f_new)
        av[t] = a

    def _check_cuda(self, f_in, f_out, av) -> None:
        self._check_tensors((("f_in", f_in), ("f_out", f_out)), av)
        if f_in.data_ptr() == f_out.data_ptr():
            raise ValueError("f_in and f_out must be distinct buffers (ping-pong)")

    def _check_tensors(self, named_fs, av) -> None:
        """Each ``(name, f)`` a contiguous CUDA tensor of :attr:`storage`
        and :attr:`f_shape` on the program's device, ``av`` a contiguous
        float32 vector there, and that device the current one."""
        shape, dtype = self.f_shape, self.storage
        for name, x in named_fs:
            if x.device.type != "cuda":
                raise ValueError(f"{name} must be a CUDA or CPU tensor, got {x.device}")
            if x.dtype != dtype or tuple(x.shape) != shape:
                raise ValueError(
                    f"{name} must be {str(dtype).removeprefix('torch.')} {shape}, "
                    f"got {x.dtype} {tuple(x.shape)}"
                )
            if not x.is_contiguous() or x.device != self.fluid.device:
                raise ValueError(f"{name} must be contiguous on {self.fluid.device}")
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

    def _check_launch(self, i: int, n: int) -> None:
        """Launch ``i`` writes av slots ``[i*chunk, (i+1)*chunk)`` of ``n``."""
        if i < 0 or (i + 1) * self.chunk > n:
            raise ValueError(
                f"launch {i} of {self.chunk} steps out of range for {n} av slots"
            )


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
        """One step ``f_in -> f_out``, ``av[t]``, checked on every call."""
        if runs_plain(f_in):
            self._plain_into(f_in, f_out, av, t)
            return
        lib = _build.load_library()
        self._check_cuda(f_in, f_out, av)
        if not 0 <= t < av.numel():
            raise ValueError(f"av index {t} out of range for {av.numel()} steps")
        _launch(lib, "lbm_fused_step", f_in.data_ptr(), f_out.data_ptr(),
                self.fluid.data_ptr(), self.partials.data_ptr(), av.data_ptr() + 4 * t,
                ctypes.addressof(self._consts),
                torch.cuda.current_stream(f_in.device).cuda_stream)

    def bind(self, f_a, f_b, av):
        """As :meth:`StepProgram.bind`; for CUDA tensors the buffers are
        checked and their pointers taken here, once, and each ``launch(t)``
        only launches."""
        if runs_plain(f_a):
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
            _launch(lib, "lbm_fused_step", ptrs[t & 1], ptrs[~t & 1], fluid, partials,
                    av0 + 4 * t, consts, stream)

        return launch


class MultiStep(StepProgram):
    """The multi-step kernel: ``chunk`` steps per launch, on one of two
    routes, decided here before any launch (:attr:`route`,
    :func:`schedule.multi_route`):

    * ``"bands"`` (``lbm_multi_bands_step``): where the grid fits bands of
      rows in shared memory, one chunk a band, over :attr:`nblocks` blocks,
      one an SM (:func:`schedule.bands_plan` at the card's SMs,
      :func:`schedule.bands_admission`), one cooperative launch, each block
      updating its band of rows in place, the edge rows handed to the
      neighbours through device memory (:attr:`slots`, tagged by step:
      :attr:`epoch` advances by ``chunk`` a launch).  Launch ``i`` reads
      ``(f_a, f_b)[(i * chunk) & 1]`` and leaves the state where the grid
      route does, in ``(f_a, f_b)[((i + 1) * chunk) & 1]`` (for an even
      chunk the buffer it read).  Its plain version (:meth:`plain_launch`)
      is the same band algorithm in torch, :func:`band_steps`, at these
      bands and threads.  Its launch's ``prologue`` zeroes the slots: a
      CUDA graph of its launches bakes in their epochs, and each replay
      starts from zeroed slots, as a fresh run does
      (:mod:`lbm_tpu_torch.graphs`).  Where the grid's bands are one chunk
      at a width the kernel is compiled for (:attr:`width`,
      :func:`schedule.bands_width`), the kernel takes its one-chunk step,
      counted by :data:`ONE_CHUNK_LAUNCHES`.
    * ``"grid"`` (``lbm_multi_step``): one cooperative launch with a grid
      barrier between steps, the state ping-ponging between the two bound
      buffers once per step; its plain version is ``chunk`` plain
      one-steps.

    ``route`` forces one (``"bands"`` raises ``ValueError`` where the grid
    does not fit its plan)."""

    def __init__(self, params, obstacles, free_cells_inv, device, chunk: int,
                 route: str | None = None) -> None:
        from lbm_tpu_torch.ops import schedule  # schedule imports this module

        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if route not in (None, "bands", "grid"):
            raise ValueError(f"route must be 'bands' or 'grid', got {route!r}")
        device = torch.device(device)
        lib = None if device.type == "cpu" else _build.load_library()
        super().__init__(params, obstacles, free_cells_inv, device)
        self.chunk = chunk
        # As lbm_tpu accounts by steps_per_pass: the state leaves the chip
        # once per launch (between its steps it stays in L2 or in shared
        # memory).
        self.bytes_per_update = BYTES_PER_CELL / chunk
        self._consts = step_params(params, free_cells_inv)
        self._fcinv = float(np.float32(free_cells_inv))
        ny, nx = params.ny, params.nx
        max_blocks = schedule.bands_admission(self.fluid.device)
        bands = schedule.bands_plan(ny, nx, max_blocks)
        if route == "bands" and bands is None:
            raise ValueError(f"grid {ny}x{nx} does not fit bands of {max_blocks} blocks")
        self.route = route or schedule.multi_route(ny, nx, max_blocks)
        self.nblocks = self.threads = self.epoch = self.width = 0
        slots = 0
        if self.route == "bands":
            self.nblocks, self.bands, self.threads, self.smem_bytes = bands
            self.width = schedule.bands_width(ny, nx, self.nblocks)
            if lib is not None:
                got = (lib.lbm_multi_bands_smem_bytes(ny, nx, self.nblocks),
                       lib.lbm_multi_bands_threads(ny, nx, self.nblocks),
                       lib.lbm_multi_bands_width(ny, nx, self.nblocks))
                if got != (self.smem_bytes, self.threads, self.width):
                    raise RuntimeError(f"the bands kernel's footprint, threads and width "
                                       f"{got} differ from the plan's "
                                       f"{(self.smem_bytes, self.threads, self.width)}")
                slots = self.nblocks * 2 * 2 * schedule.BANDS_SLOT_POPS * nx
            self._sweep = band_sweep(ny, nx, self.bands, self.threads, self.fluid.device)
        elif lib is not None:
            with torch.cuda.device(device):
                self.nblocks = lib.lbm_multi_num_blocks(ny, nx)
            if self.nblocks < 1:
                raise ValueError(f"no cooperative launch for grid {ny}x{nx} on {device}")
        self.register_buffer(
            "partials",
            torch.empty(chunk * self.nblocks if lib is not None else 0,
                        dtype=torch.float32, device=device),
        )
        # The bands route's handoff slots: 64-bit words of a value and its
        # step's tag, zeroed once, so that no tag matches before its step.
        self.register_buffer("slots", torch.zeros(slots, dtype=torch.int64, device=device))

    def plain_launch(self, f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One launch in plain torch: on the bands route the band algorithm
        (:func:`band_steps`) at the route's bands and threads, else
        ``chunk`` plain one-steps."""
        if self.route == "grid":
            return super().plain_launch(f)
        return band_steps(f, self.fluid.bool(), self.params, self._fcinv, self._sweep,
                          self.chunk)

    def bind(self, f_a, f_b, av):
        """As :meth:`StepProgram.bind`: launch ``i`` starts from
        ``(f_a, f_b)[(i * chunk) & 1]``."""
        bufs, chunk, n = (f_a, f_b), self.chunk, av.numel()
        if runs_plain(f_a):
            if self.route == "grid":
                return super().bind(f_a, f_b, av)

            def plain(i: int) -> None:
                self._check_launch(i, n)
                p = (i * chunk) & 1
                f_new, avs = self.plain_launch(bufs[p])
                bufs[p ^ (chunk & 1)].copy_(f_new)
                av[i * chunk:(i + 1) * chunk] = avs

            plain.prologue = (self.slots.zero_,)
            return plain
        lib = _build.load_library()
        self._check_cuda(f_a, f_b, av)
        ptrs = (f_a.data_ptr(), f_b.data_ptr())
        fluid, partials = self.fluid.data_ptr(), self.partials.data_ptr()
        consts = ctypes.addressof(self._consts)
        av0 = av.data_ptr()
        stream = torch.cuda.current_stream(f_a.device).cuda_stream
        if self.route == "bands":
            slots = self.slots.data_ptr()

            def bands(i: int) -> None:
                self._check_launch(i, n)
                p = (i * chunk) & 1
                _launch(lib, "lbm_multi_bands_step", ptrs[p], ptrs[p ^ (chunk & 1)], fluid,
                        slots, partials, av0 + 4 * i * chunk, chunk, self.nblocks,
                        self.epoch, consts, stream)
                ONE_CHUNK_LAUNCHES["lbm_multi_bands_step"] += self.width != 0
                self.epoch = (self.epoch + chunk) % 2**31

            bands.prologue = (self.slots.zero_,)
            return bands

        def launch(i: int) -> None:
            self._check_launch(i, n)
            p = (i * chunk) & 1
            _launch(lib, "lbm_multi_step", ptrs[p], ptrs[p ^ 1], fluid, partials,
                    av0 + 4 * i * chunk, chunk, self.nblocks, consts, stream)

        return launch


@dataclasses.dataclass
class _BandChunk:
    """Chunk j of the band algorithm's in-place sweep, for every band at
    once: the rows it updates (``cells``, grid rows), each row's band and
    thread lanes, the rows it reads as y-1, y, y+1 (``src[parity]``,
    indices into the row store of :func:`band_steps`) and their grid
    rows (for the mask and the kick), the rows it saves for the next
    chunk, and where its new first and last band rows go
    (``sends[parity]``: positions in the chunk, ghost slots)."""

    cells: torch.Tensor
    band: torch.Tensor
    lanes: torch.Tensor
    src: tuple[torch.Tensor, torch.Tensor]
    src_rows: torch.Tensor
    save_from: torch.Tensor
    save_to: torch.Tensor
    sends: tuple[tuple[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass
class BandSweep:
    """The band algorithm's bands (``(row0, rows)`` each), threads a
    block and the chunks of its in-place sweep (:func:`band_sweep`)."""

    bands: list[tuple[int, int]]
    threads: int
    chunks: list[_BandChunk]


def band_sweep(ny: int, nx: int, bands: list[tuple[int, int]], threads: int,
               device: torch.device) -> BandSweep:
    """The band algorithm's sweep: chunks of ``threads // nx`` rows of
    every band (one cell a thread), indexing the row store ``[f rows (ny); ghost
    rows (4C: slot (parity * C + band) * 2 + side, side 0 the row below
    the band, 1 the row above); saved rows (2C: slot j * C + band)]``."""
    c, per = len(bands), threads // nx
    if per < 1 or threads % 32 or threads > 1024:
        raise ValueError(f"{threads} threads cannot sweep rows of {nx} cells")
    ghost, saved = ny, ny + 4 * c

    def slot(parity, b, side):
        return ghost + (parity * c + b) * 2 + side

    out = []
    for j in range(-(-max(rows for _, rows in bands) // per)):
        first = j * per
        cells, band, lane, src_rows = [], [], [], []
        src = ([], [])
        save_from, save_to = [], []
        sends = (([], []), ([], []))
        for b, (row0, rows) in enumerate(bands):
            for ly in range(first, min(first + per, rows)):
                y = row0 + ly
                for parity in (0, 1):
                    south = (slot(parity, b, 0) if ly == 0
                             else saved + (j & 1) * c + b if ly == first else y - 1)
                    north = slot(parity, b, 1) if ly == rows - 1 else y + 1
                    src[parity].append((south, y, north))
                    if ly == 0:
                        sends[parity][0].append(len(cells))
                        sends[parity][1].append(slot(parity, (b - 1) % c, 1))
                    if ly == rows - 1:
                        sends[parity][0].append(len(cells))
                        sends[parity][1].append(slot(parity, (b + 1) % c, 0))
                cells.append(y)
                band.append(b)
                lane.append((ly - first) * nx)
                src_rows.append(((y - 1) % ny, y, (y + 1) % ny))
            if rows > first + per:
                save_from.append(row0 + first + per - 1)
                save_to.append(saved + ((j + 1) & 1) * c + b)

        def t(x):
            return torch.tensor(x, dtype=torch.long, device=device)

        out.append(_BandChunk(
            cells=t(cells), band=t(band)[:, None],
            lanes=t(lane)[:, None] + torch.arange(nx, device=device),
            src=(t(src[0]), t(src[1])), src_rows=t(src_rows),
            save_from=t(save_from), save_to=t(save_to),
            sends=tuple((t(pos), t(dst)) for pos, dst in sends)))
    return BandSweep(list(bands), threads, out)


def _lane_tree(a: torch.Tensor) -> torch.Tensor:
    """``[..., 32] -> [...]``: a warp's shuffle tree, lane l adding lane
    l + 16, then l + 8, ... (``warp_tree``)."""
    for off in (16, 8, 4, 2, 1):
        a = a[..., :off] + a[..., off:2 * off]
    return a[..., 0]


def band_steps(f: torch.Tensor, fluid: torch.Tensor, params: LBMParams, fcinv: float,
               sweep: BandSweep, steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``steps`` steps of the bands kernel's algorithm in plain torch
    (``csrc/lbm_multi_bands.cu``): ``(f after them, av[steps])``; ``f``
    is not modified.  One copy of f updated in place in the chunks of
    ``sweep`` (:func:`band_sweep`), each band's ghost rows in two
    parities (step s reads parity s & 1 and sends its first and last rows
    into the neighbours' slots of the other), the row below a chunk from
    the saved copy of the previous chunk's last row; the kick on the source
    rows whose grid row is ny-2, then the pull and the operations of the
    plain one-step.  |u| as the kernel sums it: each lane over its cells in
    chunk order, a shuffle tree per warp, the same tree over the warps,
    then the bands' partials in band order, times ``fcinv``."""
    ny, nx = f.shape[1:]
    bands, chunks, c = sweep.bands, sweep.chunks, len(sweep.bands)
    store = torch.empty(NSPEEDS, ny + 6 * c, nx, dtype=f.dtype, device=f.device)
    store[:, :ny] = f
    for b, (row0, rows) in enumerate(bands):
        store[:, ny + 2 * b] = f[:, (row0 - 1) % ny]
        store[:, ny + 2 * b + 1] = f[:, (row0 + rows) % ny]
    aw1, aw2 = accel_weights(params)
    scale = kick_scales(params, store[:, :1, None])  # [9, 1, 1, 1]
    omega = np.float32(params.omega)
    kick_rows = [ch.src_rows == ny - 2 for ch in chunks]
    masks = [fluid[ch.src_rows] for ch in chunks]
    partials = torch.empty(steps, c, dtype=f.dtype, device=f.device)
    for s in range(steps):
        acc = torch.zeros(c, sweep.threads, dtype=f.dtype, device=f.device)
        for ch, kick, m in zip(chunks, kick_rows, masks):
            e = store[:, ch.src[s & 1]]  # [9, n, 3, nx]: rows y-1, y, y+1
            ok = (kick[..., None] & m & (e[3] - float(aw1) > 0.0)
                  & (e[6] - float(aw2) > 0.0) & (e[7] - float(aw2) > 0.0))
            e = e + ok.to(e.dtype) * scale
            tmp = torch.stack([torch.roll(e[k, :, 1 - int(CY[k])], int(CX[k]), dims=-1)
                               for k in range(NSPEEDS)])
            new, _ = collide(tmp, m[:, 1], omega)
            _, rho_inv, mx, my = macroscopic(tmp)
            speed = torch.where(m[:, 1], torch.sqrt(mx * mx + my * my) * rho_inv, 0.0)
            acc[ch.band, ch.lanes] = acc[ch.band, ch.lanes] + speed
            store[:, ch.save_to] = store[:, ch.save_from]
            store[:, ch.cells] = new
            pos, dst = ch.sends[(s + 1) & 1]
            store[:, dst] = new[:, pos]
        warps = _lane_tree(acc.view(c, -1, 32))
        warps = torch.cat([warps, warps.new_zeros(c, 32 - warps.shape[1])], dim=1)
        partials[s] = _lane_tree(warps)
    total = torch.zeros(steps, dtype=f.dtype, device=f.device)
    for q in range(c):
        total = total + partials[:, q]
    return store[:, :ny].clone(), total * fcinv


class TemporalStep(StepProgram):
    """The temporal kernel: one pass (``lbm_temporal_step``) advances
    ``ksteps`` steps of ``by x bx`` tiles, each on its window of ``ksteps``
    halo cells per side, reading one bound buffer and writing the other.
    Its plain version (:meth:`plain_launch`) runs the same window algorithm
    in torch.  The kernel runs :attr:`nblocks` persistent blocks
    (:func:`persistent_grid`) that walk the tiles; a tile whose windows do
    not fit a block's shared memory (:func:`schedule.persistent_smem_bytes`)
    raises ``ValueError`` here, before any launch.  The kernel takes bound
    buffers at any address (views at an offset too): its window copies
    narrow to the alignment they find.

    ``storage`` is the dtype of the f buffers: ``torch.float32`` (the
    production default), or ``torch.float16`` / ``torch.bfloat16``, which
    launch ``lbm_temporal16_step`` (``lbm_tpu``'s ``storage=``: f widened
    to fp32 on load, every operation in fp32, rounded to nearest even once
    a pass on store; av from the fp32 window, before the rounding), the
    same persistent pass with the same footprint and its own grid."""

    def __init__(self, params, obstacles, free_cells_inv, device, by: int, bx: int,
                 ksteps: int, storage: torch.dtype = torch.float32) -> None:
        ny, nx = params.ny, params.nx
        if by < 1 or bx < 1 or ny % by or nx % bx:
            raise ValueError(f"tile {by}x{bx} does not divide grid {ny}x{nx}")
        if ksteps < 1:
            raise ValueError(f"ksteps must be >= 1, got {ksteps}")
        if storage not in STORAGE_DTYPES:
            raise ValueError(f"storage must be one of {STORAGE_DTYPES}, got {storage!r}")
        _check_footprint(by, bx, ksteps)
        device = torch.device(device)
        lib = None if device.type == "cpu" else _build.load_library()
        super().__init__(params, obstacles, free_cells_inv, device)
        self.chunk, self.by, self.bx, self.storage = ksteps, by, bx, storage
        self.bytes_per_update = window_bytes_per_update(by, bx, ksteps,
                                                        storage.itemsize)
        self._consts = step_params(params, free_cells_inv)
        self._fcinv = float(np.float32(free_cells_inv))
        tiles = (ny // by) * (nx // bx)
        occupancy = (("lbm_temporal_blocks_per_sm", 0) if storage == torch.float32 else
                     ("lbm_temporal16_blocks_per_sm", int(storage == torch.bfloat16)))
        self.nblocks = (persistent_blocks(lib, self.fluid.device, tiles, by, bx, ksteps,
                                          *occupancy) if lib is not None else 0)
        self.register_buffer(
            "partials",
            torch.empty(ksteps * tiles if lib is not None else 0,
                        dtype=torch.float32, device=device),
        )

    def final_index(self, n_launches: int) -> int:
        """One flip per pass."""
        return n_launches & 1

    def plain_launch(self, f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One pass in plain torch, the kernel's window algorithm: gather
        every tile's window by periodic index, run ``ksteps`` steps on it
        with ``torch.roll`` inside the window (the edges wrap garbage that
        leaves the valid region), crop the centres, and sum the owned
        |u| at each step.  Each cell runs the operations of the plain
        one-step in the same order.  A 16-bit f is widened to fp32 first
        and the new f rounded back (``.to``, to nearest even); av comes
        from the fp32 pass."""
        out, av = self._window_pass(f.to(torch.float32))
        return out.to(self.storage), av

    def _window_pass(self, f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        ny, nx = self.params.ny, self.params.nx
        k, by, bx = self.chunk, self.by, self.bx
        dev = f.device
        rows = (torch.arange(ny // by, device=dev)[:, None] * by - k
                + torch.arange(by + 2 * k, device=dev)) % ny  # [Ty, wy]
        cols = (torch.arange(nx // bx, device=dev)[:, None] * bx - k
                + torch.arange(bx + 2 * k, device=dev)) % nx  # [Tx, wx]
        ri, ci = rows[:, None, :, None], cols[None, :, None, :]
        ctr = (..., slice(k, k + by), slice(k, k + bx))
        fluid = self.fluid.bool()[ri, ci]  # [Ty, Tx, wy, wx]
        w, sums = advance_windows(f[:, ri, ci], fluid, (rows == ny - 2)[:, None, :, None],
                                  k, ctr, self.params)
        out = w[ctr].permute(0, 1, 3, 2, 4).reshape(NSPEEDS, ny, nx)
        return out, torch.stack(sums) * self._fcinv

    def bind(self, f_a, f_b, av):
        """Pass ``i`` reads ``(f_a, f_b)[i & 1]``, writes the other and
        ``av[i*ksteps : (i+1)*ksteps]``."""
        bufs, k, n = (f_a, f_b), self.chunk, av.numel()
        if runs_plain(f_a):
            if f_a.dtype != self.storage or f_b.dtype != self.storage:
                raise ValueError(f"f_a and f_b must be {self.storage}, got {f_a.dtype} "
                                 f"and {f_b.dtype}")

            def plain(i: int) -> None:
                self._check_launch(i, n)
                f_new, avs = self.plain_launch(bufs[i & 1])
                bufs[~i & 1].copy_(f_new)
                av[i * k:(i + 1) * k] = avs

            return plain
        lib = _build.load_library()
        self._check_cuda(f_a, f_b, av)
        ptrs = (f_a.data_ptr(), f_b.data_ptr())
        fluid, partials = self.fluid.data_ptr(), self.partials.data_ptr()
        consts = ctypes.addressof(self._consts)
        av0, by, bx = av.data_ptr(), self.by, self.bx
        stream = torch.cuda.current_stream(f_a.device).cuda_stream
        name, tail = (("lbm_temporal_step", (self.nblocks,))
                      if self.storage == torch.float32
                      else ("lbm_temporal16_step",
                            (self.nblocks, int(self.storage == torch.bfloat16))))

        def launch(i: int) -> None:
            self._check_launch(i, n)
            _launch(lib, name, ptrs[i & 1], ptrs[~i & 1], fluid, partials,
                    av0 + 4 * i * k, consts, by, bx, k, *tail, stream)

        return launch


def persistent_grid(tiles: int, sms: int, per_sm: int) -> int:
    """Blocks of a persistent pass (the temporal or the in-place one): as
    many as the card holds at once (``sms * per_sm``), but no more than
    there are tiles; block ``b`` walks tiles ``b, b + grid, ...``, so every
    tile runs exactly once."""
    return min(tiles, sms * per_sm)


def persistent_blocks(lib, device: torch.device, tiles: int, by: int, bx: int,
                      ksteps: int, occupancy: str = "lbm_temporal_blocks_per_sm",
                      flag: int = 0) -> int:
    """:func:`persistent_grid` on ``device``: its SM count
    (``cudaDevAttrMultiProcessorCount``) and the blocks of the pass one SM
    holds at this tile, from the program's own occupancy entry of the
    library (``occupancy(by, bx, ksteps, flag)``: the flag picks a shard
    entry or a 16-bit type)."""
    with torch.cuda.device(device):
        sms = lib.lbm_sm_count(torch.cuda.current_device())
        per_sm = getattr(lib, occupancy)(by, bx, ksteps, flag)
    if sms < 1 or per_sm < 0:
        code = -min(sms, per_sm)
        raise RuntimeError(f"cannot size the grid of {occupancy}({flag}) on {device}: "
                           f"{lib.lbm_error_string(code).decode()}")
    if per_sm == 0:
        raise ValueError(f"no block of {occupancy}({flag}) fits an SM at tile "
                         f"{by}x{bx}, K {ksteps}")
    return persistent_grid(tiles, sms, per_sm)


def _check_footprint(by: int, bx: int, ksteps: int) -> None:
    """ValueError unless a persistent pass's shared memory at this tile
    (:func:`schedule.persistent_smem_bytes`; every window kernel runs one)
    fits a block."""
    from lbm_tpu_torch.ops import schedule  # schedule imports this module

    need = schedule.persistent_smem_bytes(by, bx, ksteps)
    budget = schedule.PERSISTENT_SMEM_BUDGET
    if need > budget:
        raise ValueError(f"the window of tile {by}x{bx} at K {ksteps} needs {need} B of "
                         f"shared memory, more than a block's {budget}")


@dataclasses.dataclass
class BandCarry:
    """The state of an in-place program between launches: the one f
    buffer, the bands of both parities (``[2, band_floats]``), and the
    parity the next pass reads."""

    f: torch.Tensor
    bands: torch.Tensor
    parity: int = 0


@dataclasses.dataclass
class CheckpointIO:
    """Carry <-> host-``f`` conversion for checkpointed runs that keep the
    carry on the device between segments (``lbm_tpu.ops.fused
    .CheckpointIO``): ``to_f_host(carry)`` copies the f buffer to the host
    (f keeps its [9, ny, nx] layout, so no relayout), ``from_f_host(f)``
    uploads f and fills the bands from it.  Snapshots stay in the portable
    v1 f-format."""

    to_f_host: Callable[[BandCarry], np.ndarray]
    from_f_host: Callable[[np.ndarray], BandCarry]


class _InPlaceTemporal(StepProgram):
    """K steps per pass on ``by x bx`` tiles of ONE f buffer, updated in
    place, each tile's halo read from carried bands (the design and the
    proof that no tile races another are the head note of
    ``csrc/lbm_temporal_xt.cu``); ``tpasses`` passes per launch.  A tile
    whose windows do not fit a block's shared memory raises ``ValueError``
    before the library is built: the persistent pass's footprint
    (:func:`schedule.persistent_smem_bytes`), which every in-place kernel
    runs.

    A run binds one buffer (``n_buffers == 1``): ``bind(f, av)`` fills the
    bands from f (:meth:`init`) and returns ``launch(i)``, which advances
    f in place; :meth:`bind_carry` continues a :class:`BandCarry` across
    binds.  A launch's ``prologue`` (:meth:`restart`) fills the bands of
    parity 0 from f again, which a CUDA graph of its launches records as
    its start (:mod:`lbm_tpu_torch.graphs`).  The plain version runs the same band algorithm in torch:
    windows gathered from f (own cells) and the bands (halo), the window
    steps of :func:`advance_windows`, centres written back into f, and the
    bands of the next parity filled from the new f."""

    n_buffers = 1
    # Window elements (9 planes) one plain chunk of tile rows may gather.
    _PLAIN_WINDOW_ELEMS = 2**25

    # Whether the kernel is the shard entry.
    shard_entry = False

    def __init__(self, params, obstacles, free_cells_inv, device, by: int, bx: int,
                 ksteps: int, tpasses: int) -> None:
        _check_footprint(by, bx, ksteps)
        device = torch.device(device)
        self._lib = None if device.type == "cpu" else _build.load_library()
        super().__init__(params, obstacles, free_cells_inv, device)
        self._init_tiles(params.ny, 0, by, bx, ksteps, tpasses, free_cells_inv, device)

    def _init_tiles(self, rows, row0, by, bx, ksteps, tpasses, free_cells_inv,
                    device) -> None:
        """The tiling of a slab of ``rows`` x nx cells from global row
        ``row0`` (the whole grid, or a shard's rows): tiles, band layout,
        constants and partials."""
        nx = self.params.nx
        if by < 1 or bx < 1 or rows % by or nx % bx:
            raise ValueError(f"tile {by}x{bx} does not divide grid {rows}x{nx}")
        if ksteps < 1 or tpasses < 1:
            raise ValueError(f"ksteps and tpasses must be >= 1, got {ksteps}, {tpasses}")
        self.rows, self.row0 = rows, row0
        self.by, self.bx, self.ksteps, self.tpasses = by, bx, ksteps, tpasses
        self.chunk = ksteps * tpasses
        self.tiles = (rows // by, nx // bx)
        self.nbr, self.nbc = min(2 * ksteps, by), min(2 * ksteps, bx)
        self.rb_floats = NSPEEDS * self.tiles[0] * self.nbr * nx
        self.band_floats = self.rb_floats + NSPEEDS * rows * self.tiles[1] * self.nbc
        self.bytes_per_update = inplace_bytes_per_update(by, bx, ksteps)
        self._consts = step_params(self.params, free_cells_inv)
        self._av_scale = float(np.float32(free_cells_inv))
        # The slab rows of the row bands and the columns of the column
        # bands, in band order.
        self.register_buffer("band_rows", torch.as_tensor(
            _band_index(self.tiles[0], by, ksteps), device=device))
        self.register_buffer("band_cols", torch.as_tensor(
            _band_index(self.tiles[1], bx, ksteps), device=device))
        self.register_buffer("partials", torch.empty(
            self.chunk * self.tiles[0] * self.tiles[1] if self._lib is not None else 0,
            dtype=torch.float32, device=device))
        self.nblocks = 0 if self._lib is None else self._grid_blocks()

    def _grid_blocks(self) -> int:
        """The kernel's persistent grid, sized from the card."""
        return persistent_blocks(self._lib, self.fluid.device, self.tiles[0] * self.tiles[1],
                                 self.by, self.bx, self.ksteps,
                                 "lbm_temporal_xt_blocks_per_sm", int(self.shard_entry))

    @property
    def f_shape(self) -> tuple[int, int, int]:
        return (NSPEEDS, self.rows, self.params.nx)

    def final_index(self, n_launches: int) -> int:
        return 0

    def _views(self, flat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One parity of the bands as (RB [9, Ty*nbr, nx], CB [9, rows, Tx*nbc])."""
        return (flat[:self.rb_floats].view(NSPEEDS, -1, self.params.nx),
                flat[self.rb_floats:].view(NSPEEDS, self.rows, -1))

    def _fill_bands(self, f: torch.Tensor, flat: torch.Tensor) -> None:
        rb, cb = self._views(flat)
        torch.index_select(f, 1, self.band_rows, out=rb)
        torch.index_select(f, 2, self.band_cols, out=cb)

    def init(self, f: torch.Tensor) -> BandCarry:
        """The carry of a run from ``f`` (used in place, not copied): the
        bands of parity 0 filled from f, as ``lbm_tpu``'s ``ghosts_of``."""
        shape = self.f_shape
        if tuple(f.shape) != shape or f.dtype != torch.float32 or not f.is_contiguous():
            raise ValueError(f"f must be contiguous float32 {shape}, got "
                             f"{f.dtype} {tuple(f.shape)}")
        bands = torch.empty(2, self.band_floats, dtype=torch.float32, device=f.device)
        self._fill_bands(f, bands[0])
        return BandCarry(f, bands)

    def restart(self, carry: BandCarry) -> None:
        """``carry`` as a run from its f starts: the bands of parity 0
        filled from f (the bands of the parity a pass leaves hold f's band
        cells, so this changes no bit where they are current)."""
        self._fill_bands(carry.f, carry.bands[0])
        carry.parity = 0

    def bind(self, f: torch.Tensor, av: torch.Tensor):
        """``launch(i)`` advances the one buffer ``f`` in place by launch
        ``i``'s ``chunk`` steps and writes ``av[i*chunk : (i+1)*chunk]``."""
        return self.bind_carry(self.init(f), av)

    def bind_carry(self, carry: BandCarry, av: torch.Tensor):
        """As :meth:`bind`, continuing ``carry`` (its parity advances with
        every pass)."""
        n, k = av.numel(), self.ksteps
        if runs_plain(carry.f):

            def launch(i: int) -> None:
                self._check_launch(i, n)
                for t in range(self.tpasses):
                    s0 = i * self.chunk + t * k
                    self._plain_pass(carry, av[s0:s0 + k], *self._own_edges(carry.f))

        else:
            self._check_carry(carry, av)
            launch = self._cuda_launcher(_build.load_library(), carry, av)
        launch.prologue = (lambda: self.restart(carry),)
        return launch

    def single(self, f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        carry = self.init(f.clone())
        av = torch.empty(self.chunk, dtype=torch.float32, device=f.device)
        self.bind_carry(carry, av)(0)
        return carry.f, (av[0] if self.chunk == 1 else av)

    def plain_launch(self, f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One launch in plain torch, the band algorithm: ``(f after chunk
        steps, av[chunk])``; ``f`` is not modified."""
        carry = self.init(f.clone())
        av = torch.empty(self.chunk, dtype=torch.float32, device=f.device)
        for t in range(self.tpasses):
            self._plain_pass(carry, av[t * self.ksteps:(t + 1) * self.ksteps],
                             *self._own_edges(carry.f))
        return carry.f, av

    def _own_edges(self, f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """A grid as its own one shard, periodic in y: ``(ghost, mask_ext)``
        of :meth:`_plain_pass` from f's and the mask's opposite edges."""
        k, rows = self.ksteps, self.rows
        ly = torch.arange(-k, rows + k, device=f.device) % rows
        return (f.index_select(1, torch.cat([ly[:k], ly[-k:]])),
                self.fluid.index_select(0, ly))

    def _plain_pass(self, carry: BandCarry, av_out: torch.Tensor, ghost: torch.Tensor,
                    mask_ext: torch.Tensor) -> None:
        """One pass of the band algorithm on ``carry``, in place, in chunks
        of tile rows: each tile's window from f (its own cells), the bands
        of ``carry.parity`` (the halo) and ``ghost`` (the [9, 2K, nx] rows
        below and above the slab), its mask from ``mask_ext`` (the slab's
        padded by K rows), K window steps, the centres written into f; then
        the bands of the other parity from the new f."""
        f, p = carry.f, carry.parity
        ny, nx, rows = self.params.ny, self.params.nx, self.rows
        k, by, bx = self.ksteps, self.by, self.bx
        (ty_n, tx_n), nbr, nbc = self.tiles, self.nbr, self.nbc
        dev = f.device
        rb, cb = self._views(carry.bands[p])
        src = torch.cat([f.view(NSPEEDS, -1), rb.reshape(NSPEEDS, -1),
                         cb.reshape(NSPEEDS, -1), ghost.reshape(NSPEEDS, -1)], dim=1)
        f_cells, rb_cells = rows * nx, rb.shape[1] * nx
        g_base = f_cells + rb_cells + cb.shape[1] * cb.shape[2]
        wmask = mask_ext.bool().view(-1)
        ctr = (..., slice(k, k + by), slice(k, k + bx))
        wy, wx = by + 2 * k, bx + 2 * k
        gx = (torch.arange(tx_n, device=dev)[:, None] * bx - k
              + torch.arange(wx, device=dev)) % nx  # [Tx, wx]
        ox = gx // bx
        c = gx - ox * bx
        gx, ox, c = gx[None, :, None, :], ox[None, :, None, :], c[None, :, None, :]
        tx = torch.arange(tx_n, device=dev)[None, :, None, None]
        step = max(1, self._PLAIN_WINDOW_ELEMS // (NSPEEDS * tx_n * wy * wx))
        sums = torch.zeros(k, dtype=torch.float32, device=dev)
        for t0 in range(0, ty_n, step):
            tys = torch.arange(t0, min(ty_n, t0 + step), device=dev)
            ly = tys[:, None] * by - k + torch.arange(wy, device=dev)  # [n, wy] slab rows
            out = (ly < 0) | (ly >= rows)  # rows outside the slab are ghost rows
            ghost_row = torch.where(ly < 0, ly + k, ly - rows + k)
            gy = ly.clamp(0, rows - 1)
            oy = gy // by
            r = gy - oy * by
            ly, gy, oy, r, out, ghost_row = (x[:, None, :, None] for x in (
                ly, gy, oy, r, out, ghost_row))
            ty = tys[:, None, None, None]
            own = ~out & (oy == ty) & (ox == tx)
            in_rb = ~out & ~own & (oy != ty)
            in_cb = ~out & ~own & (oy == ty)
            if bool((in_rb & ~_in_band(r, by, k)).any() | (in_cb & ~_in_band(c, bx, k)).any()):
                raise RuntimeError("a halo cell lies outside the bands")
            fidx = gy * nx + gx  # [n, Tx, wy, wx]
            idx = torch.where(own, fidx, torch.where(
                in_rb, f_cells + (oy * nbr + _band_slot(r, by, k)) * nx + gx,
                f_cells + rb_cells + gy * (tx_n * nbc) + ox * nbc + _band_slot(c, bx, k)))
            idx = torch.where(out, g_base + ghost_row * nx + gx, idx)
            kick = (self.row0 + ly) % ny == ny - 2
            w, step_sums = advance_windows(
                src[:, idx], wmask[(ly + k) * nx + gx], kick, k, ctr, self.params)
            f[:, t0 * by:(t0 + len(tys)) * by, :] = (
                w[ctr].permute(0, 1, 3, 2, 4).reshape(NSPEEDS, -1, nx))
            sums += torch.stack(step_sums)
        av_out.copy_(sums * self._av_scale)
        self._fill_bands(f, carry.bands[p ^ 1])
        carry.parity = p ^ 1

    def _check_carry(self, carry: BandCarry, av: torch.Tensor) -> None:
        self._check_tensors((("f", carry.f),), av)
        bands = carry.bands
        if (bands.dtype != torch.float32 or tuple(bands.shape) != (2, self.band_floats)
                or not bands.is_contiguous() or bands.device != self.fluid.device):
            raise ValueError(f"bands must be contiguous float32 (2, {self.band_floats}) "
                             f"on {self.fluid.device}")

    def _cuda_launcher(self, lib, carry: BandCarry, av: torch.Tensor):
        raise NotImplementedError


class TemporalXtStep(_InPlaceTemporal):
    """The x-tiled kernel (``lbm_temporal_xt_step``): one in-place pass of
    ``ksteps`` steps per launch by :attr:`nblocks` persistent blocks
    (:func:`persistent_grid`) that walk the tiles; the giant-grid
    schedule.  Its :attr:`checkpoint_io` lets a checkpointed run keep the
    carry on the device between segments."""

    def __init__(self, params, obstacles, free_cells_inv, device, by: int, bx: int,
                 ksteps: int) -> None:
        super().__init__(params, obstacles, free_cells_inv, device, by, bx, ksteps, 1)
        self.checkpoint_io = CheckpointIO(self.to_f_host, self.from_f_host)

    def to_f_host(self, carry: BandCarry) -> np.ndarray:
        return carry.f.to("cpu", copy=True).numpy()

    def from_f_host(self, f: np.ndarray) -> BandCarry:
        return self.init(torch.tensor(np.asarray(f, dtype=np.float32),
                                      device=self.fluid.device))

    def _cuda_launcher(self, lib, carry, av):
        f, bands = carry.f.data_ptr(), (carry.bands[0].data_ptr(),
                                        carry.bands[1].data_ptr())
        fluid, partials = self.fluid.data_ptr(), self.partials.data_ptr()
        consts = ctypes.addressof(self._consts)
        av0, n, k, by, bx = av.data_ptr(), av.numel(), self.ksteps, self.by, self.bx
        nblocks = self.nblocks
        stream = torch.cuda.current_stream(carry.f.device).cuda_stream

        def launch(i: int) -> None:
            self._check_launch(i, n)
            p = carry.parity
            _launch(lib, "lbm_temporal_xt_step", f, bands[p], bands[p ^ 1], fluid,
                    partials, av0 + 4 * i * k, consts, by, bx, k, nblocks, stream)
            carry.parity = p ^ 1

        return launch


class MegaStep(_InPlaceTemporal):
    """The megakernel (``lbm_mega_step``, ``kernel="mega"``): ``tpasses``
    persistent in-place passes of ``ksteps`` steps (the x-tiled kernel's)
    in one cooperative launch of :attr:`nblocks` co-resident blocks, with
    a grid barrier between passes."""

    def _grid_blocks(self) -> int:
        """Every block of a cooperative launch must be co-resident: the
        megakernel's own occupancy at the persistent footprint
        (``lbm_mega_num_blocks``), capped at the tile count."""
        ny, nx = self.params.ny, self.params.nx
        with torch.cuda.device(self.fluid.device):
            n = self._lib.lbm_mega_num_blocks(ny, nx, self.by, self.bx, self.ksteps)
        if n < 1:
            raise ValueError(f"no cooperative launch for grid {ny}x{nx} at tile "
                             f"{self.by}x{self.bx}, K {self.ksteps} on {self.fluid.device}")
        return n

    def _cuda_launcher(self, lib, carry, av):
        f, b0, b1 = (t.data_ptr() for t in (carry.f, carry.bands[0], carry.bands[1]))
        fluid, partials = self.fluid.data_ptr(), self.partials.data_ptr()
        consts = ctypes.addressof(self._consts)
        av0, n, chunk = av.data_ptr(), av.numel(), self.chunk
        args = (self.by, self.bx, self.ksteps, self.tpasses)
        stream = torch.cuda.current_stream(carry.f.device).cuda_stream

        def launch(i: int) -> None:
            self._check_launch(i, n)
            _launch(lib, "lbm_mega_step", f, b0, b1, fluid, partials,
                    av0 + 4 * i * chunk, consts, *args, carry.parity, self.nblocks,
                    stream)
            carry.parity ^= self.tpasses & 1

        return launch


def _band_index(tiles: int, b: int, ksteps: int) -> np.ndarray:
    """The grid rows (columns) of the row (column) bands, in band order:
    each tile's local rows r < K and r >= b - K, ascending."""
    local = [r for r in range(b) if r < ksteps or r >= b - ksteps]
    return np.array([t * b + r for t in range(tiles) for r in local], dtype=np.int64)


def _in_band(r: torch.Tensor, b: int, ksteps: int) -> torch.Tensor:
    return (r < ksteps) | (r >= b - ksteps)


def _band_slot(r: torch.Tensor, b: int, ksteps: int) -> torch.Tensor:
    """Slot of local row (column) ``r`` among its tile's band rows."""
    if 2 * ksteps >= b:
        return r
    return torch.where(r < ksteps, r, r - b + 2 * ksteps)


def inplace_bytes_per_update(by: int, bx: int, ksteps: int) -> float:
    """Device-memory bytes per cell update of an in-place pass: the window
    read once (9 fp32 and the mask byte per cell; its halo from the
    bands), the centre written once and the tile's band cells written
    once (9 fp32 each), over the ``by * bx * ksteps`` updates."""
    window = (by + 2 * ksteps) * (bx + 2 * ksteps)
    band_cells = min(2 * ksteps, by) * bx + by * min(2 * ksteps, bx)
    return (window * (9 * 4 + 1) + (by * bx + band_cells) * 9 * 4) / (by * bx * ksteps)


def advance_windows(w, fluid, kick_rows, ksteps, ctr, params):
    """``ksteps`` steps of the windows ``w`` [9, ..., wy, wx] (fluid mask
    ``fluid`` [..., wy, wx]; ``kick_rows`` True where a window row is
    ny-2), in plain torch: the temporal kernels' window algorithm.  Each
    step runs ``torch.roll`` inside the window (the edges wrap garbage that
    leaves the valid region) and the operations of the plain one-step in
    the same order.  Returns the final windows and, per step, the |u| sum
    over the fluid cells of the centres ``w[ctr]`` (unscaled)."""
    aw1, aw2 = accel_weights(params)
    scale = kick_scales(params, w)
    omega = np.float32(params.omega)
    sums = []
    for _ in range(ksteps):
        ok = (kick_rows & fluid & (w[3] - float(aw1) > 0.0)
              & (w[6] - float(aw2) > 0.0) & (w[7] - float(aw2) > 0.0))
        w = w + ok.to(w.dtype) * scale
        tmp = torch.stack([
            torch.roll(w[q], (int(CY[q]), int(CX[q])), dims=(-2, -1))
            for q in range(NSPEEDS)
        ])
        w, _ = collide(tmp, fluid, omega)
        _, rho_inv, mx, my = macroscopic(tmp[ctr])
        speed = torch.sqrt(mx * mx + my * my) * rho_inv
        sums.append(torch.sum(torch.where(fluid[ctr], speed, 0.0)))
    return w, sums


def window_bytes_per_update(by: int, bx: int, ksteps: int, itemsize: int = 4) -> float:
    """Device-memory bytes per cell update of a temporal pass: the window
    read once (9 populations of ``itemsize`` bytes and the mask byte per
    cell), the centre written once (9 populations), over the ``by * bx *
    ksteps`` updates of the pass."""
    window = (by + 2 * ksteps) * (bx + 2 * ksteps)
    f_bytes = NSPEEDS * itemsize
    return (window * (f_bytes + 1) + by * bx * f_bytes) / (by * bx * ksteps)


class ShardProgram(torch.nn.Module):
    """``chunk`` steps per launch of ONE shard of a sharded run, on its
    halo-padded tile (:class:`lbm_tpu_torch.parallel.halo.TileLayout`:
    buffers ``[9, nyl + 2h, stride]``, the owned cells at rows
    ``[h, h + nyl)`` and columns ``[lpad, lpad + nxl)``).  The caller fills
    the halo of the buffer a launch reads; the launch writes the owned
    cells of the other.

    The :class:`StepProgram` contract per shard: ``launch = bind(f_a, f_b,
    sums)``; ``launch(i)`` reads ``(f_a, f_b)[i & 1]`` and writes
    ``sums[i*chunk : (i+1)*chunk]``, the shard's unscaled |u| sums, which
    the sharded run adds over the shards in mesh order and scales by
    1/free_cells.  :meth:`plain_launch` is the plain torch version of one
    launch, ``f_pad -> (owned cells after chunk steps, sums[chunk])``.
    Kicks go by global row: the shard knows its global row 0 (``row0``)
    and ny, so the tile rows (own or halo) whose global row is ny-2 kick.

    This class runs its plain version on any device (``kernel =
    "reference"``): one step, the masked kick and the ghost-aware stream
    of ``lbm_tpu``'s ``make_sharded_run``, then the collision."""

    chunk = 1
    halo = 1
    bytes_per_update = float(BYTES_PER_CELL)

    def __init__(self, params: LBMParams, fluid_pad: np.ndarray, layout: TileLayout,
                 row0: int, free_cells_inv: np.float32, device: torch.device) -> None:
        super().__init__()
        if layout.halo != self.halo:
            raise ValueError(f"{type(self).__name__} needs a {self.halo}-cell halo, "
                             f"got {layout.halo}")
        if fluid_pad.shape != (layout.rows, layout.stride) or fluid_pad.dtype != np.uint8:
            raise ValueError(f"padded mask must be uint8 {(layout.rows, layout.stride)}, "
                             f"got {fluid_pad.dtype} {fluid_pad.shape}")
        if not 0 <= row0 <= params.ny - layout.nyl:
            raise ValueError(f"shard rows [{row0}, {row0 + layout.nyl}) outside the "
                             f"grid's {params.ny}")
        self.params, self.layout, self.row0 = params, layout, row0
        self.register_buffer("fluid", torch.as_tensor(fluid_pad, device=device))
        rows = (row0 - layout.halo + np.arange(layout.rows)) % params.ny
        self.register_buffer("kick_rows", torch.as_tensor(
            (rows == params.ny - 2)[:, None], device=device))
        self._omega = np.float32(params.omega)
        self._consts = step_params(params, free_cells_inv)

    _check_launch = StepProgram._check_launch

    def final_index(self, n_launches: int) -> int:
        """One flip per launch."""
        return n_launches & 1

    def bind_plain(self, f_a: torch.Tensor, f_b: torch.Tensor, sums: torch.Tensor):
        """As :meth:`bind`, the plain version on any device (what the
        kernels are held against on the card)."""
        return ShardProgram.bind(self, f_a, f_b, sums)

    def plain_launch(self, f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One step of the padded tile ``f`` in plain torch: the masked kick
        on the tile with its halo, the ghost-aware pull, the collision of
        the owned cells; ``(owned f', sums[1])``."""
        lay = self.layout
        ext = accelerate_masked(lay.ext(f), lay.ext(self.fluid).bool(), self.kick_rows,
                                self.params)
        f_new, tot = collide(stream_with_ghosts(ext), lay.interior(self.fluid).bool(),
                             self._omega)
        return f_new, tot.reshape(1)

    def bind(self, f_a: torch.Tensor, f_b: torch.Tensor, sums: torch.Tensor):
        """``launch(i)`` of a ping-pong run over ``(f_a, f_b)`` in plain
        torch (:meth:`plain_launch`)."""
        bufs, chunk, n = (f_a, f_b), self.chunk, sums.numel()

        def launch(i: int) -> None:
            self._check_launch(i, n)
            f_new, s = self.plain_launch(bufs[i & 1])
            self.layout.interior(bufs[~i & 1]).copy_(f_new)
            sums[i * chunk:(i + 1) * chunk] = s

        return launch

    def _check_cuda(self, f_a, f_b, sums) -> None:
        """Both buffers contiguous float32 of the layout's shape on the
        program's device, distinct, ``sums`` a contiguous float32 vector
        there, and that device the current one."""
        dev, shape = self.fluid.device, self.layout.shape
        for name, x in (("f_a", f_a), ("f_b", f_b)):
            if x.device.type != "cuda":
                raise ValueError(f"{name} must be a CUDA or CPU tensor, got {x.device}")
            if (x.dtype != torch.float32 or tuple(x.shape) != shape
                    or not x.is_contiguous() or x.device != dev):
                raise ValueError(f"{name} must be contiguous float32 {shape} on {dev}, "
                                 f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        if f_a.data_ptr() == f_b.data_ptr():
            raise ValueError("f_a and f_b must be distinct buffers (ping-pong)")
        if sums.dtype != torch.float32 or sums.device != dev or not sums.is_contiguous():
            raise ValueError(f"sums must be a contiguous float32 vector on {dev}")
        if dev.index != torch.cuda.current_device():
            raise ValueError(f"launch on {dev} needs it to be the current CUDA device "
                             f"(now cuda:{torch.cuda.current_device()})")


class _ShardKernel(ShardProgram):
    """A shard program with a CUDA kernel (the C function ``kernel``): CUDA
    tensors launch it, CPU tensors take the plain version; anything else
    raises.  Constructing one for a non-CPU device builds the kernel
    library first, so a failed build raises there."""

    kernel = ""

    def _tiling(self) -> tuple[int, ...]:
        """The kernel's arguments after the tile's geometry."""
        return ()

    def bind(self, f_a, f_b, sums):
        """As :meth:`ShardProgram.bind`; for CUDA tensors the buffers are
        checked and their pointers taken here, once, and each
        ``launch(i)`` only launches."""
        if runs_plain(f_a):
            return super().bind(f_a, f_b, sums)
        lib = _build.load_library()
        self._check_cuda(f_a, f_b, sums)
        ptrs = (f_a.data_ptr(), f_b.data_ptr())
        mask, partials = self.fluid.data_ptr(), self.partials.data_ptr()
        consts = ctypes.addressof(self._consts)
        s0, n, per = sums.data_ptr(), sums.numel(), 4 * self.chunk
        lay = self.layout
        args = (lay.nyl, lay.nxl, lay.stride, lay.lpad, self.row0, *self._tiling())
        stream = torch.cuda.current_stream(f_a.device).cuda_stream

        def launch(i: int) -> None:
            self._check_launch(i, n)
            _launch(lib, self.kernel, ptrs[i & 1], ptrs[~i & 1], mask, partials,
                    s0 + per * i, consts, *args, stream)

        return launch


class ShardStep(_ShardKernel):
    """The shard one-step kernel (``lbm_shard_step``)."""

    kernel = "lbm_shard_step"

    def __init__(self, params, fluid_pad, layout, row0, free_cells_inv, device) -> None:
        device = torch.device(device)
        lib = None if device.type == "cpu" else _build.load_library()
        super().__init__(params, fluid_pad, layout, row0, free_cells_inv, device)
        n_partials = 0
        if lib is not None:
            n_partials = lib.lbm_shard_num_partials(layout.nyl, layout.nxl)
            if n_partials < 0:
                raise ValueError(f"tile {layout.nyl}x{layout.nxl} exceeds the kernel's "
                                 "launch limits")
        self.register_buffer("partials", torch.empty(n_partials, dtype=torch.float32,
                                                     device=device))


class ShardTemporalStep(_ShardKernel):
    """The shard temporal kernel (``lbm_shard_temporal_step``): one pass of
    ``ksteps`` steps over the ``by x bx`` tiles of a shard padded by K
    cells, by :attr:`nblocks` persistent blocks, as :class:`TemporalStep`.
    Needs ``by | nyl``, ``bx | nxl``, ``K <= min(nyl, nxl)`` (the layout's
    halo is K) and the window within a block's shared memory, else
    ``ValueError`` here; JAX's ``K <= BY-2`` is not needed, since kicks go
    by global row.  Its plain version runs the temporal window
    algorithm (:func:`advance_windows`) on the whole tile with its halo as
    one window."""

    kernel = "lbm_shard_temporal_step"

    def __init__(self, params, fluid_pad, layout, row0, free_cells_inv, device,
                 by: int, bx: int) -> None:
        ksteps = layout.halo
        if by < 1 or bx < 1 or layout.nyl % by or layout.nxl % bx:
            raise ValueError(f"tile {by}x{bx} does not divide shard "
                             f"{layout.nyl}x{layout.nxl}")
        _check_footprint(by, bx, ksteps)
        device = torch.device(device)
        lib = None if device.type == "cpu" else _build.load_library()
        self.halo = self.chunk = ksteps  # before the base's check of the halo
        super().__init__(params, fluid_pad, layout, row0, free_cells_inv, device)
        self.by, self.bx = by, bx
        self.bytes_per_update = window_bytes_per_update(by, bx, ksteps)
        tiles = (layout.nyl // by) * (layout.nxl // bx)
        self.nblocks = (0 if lib is None else
                        persistent_blocks(lib, self.fluid.device, tiles, by, bx, ksteps,
                                          "lbm_temporal_blocks_per_sm", 1))
        self.register_buffer("partials", torch.empty(
            ksteps * tiles if lib is not None else 0, dtype=torch.float32, device=device))

    def _tiling(self) -> tuple[int, ...]:
        return (self.by, self.bx, self.chunk, self.nblocks)

    def plain_launch(self, f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        lay, k = self.layout, self.chunk
        ctr = (..., slice(k, k + lay.nyl), slice(k, k + lay.nxl))
        w, sums = advance_windows(lay.ext(f), lay.ext(self.fluid).bool(), self.kick_rows,
                                  k, ctr, self.params)
        return w[ctr], torch.stack(sums)


class ShardTemporalXtStep(_InPlaceTemporal):
    """The shard x-tiled kernel (``lbm_shard_temporal_xt_step``): one
    in-place pass of ``ksteps`` steps over the ``by x bx`` tiles of one
    shard's row slab ``f [9, nyl, nx]`` (global rows from ``row0``; x is
    never split between shards), each tile's halo from the slab's own bands
    as in :class:`TemporalXtStep`, except the rows beyond the slab, which
    come from a ghost buffer ``[9, 2K, nx]``: the south neighbour's last K
    rows, then the north neighbour's first K.  The caller fills it before
    each pass (:class:`lbm_tpu_torch.parallel.halo.GhostExchange`) and
    nothing in the pass writes it.  The mask ``mask_ext`` is the slab's
    padded by K rows by global row (:meth:`SlabLayout.pad_mask`).  Needs
    ``by | nyl``, ``bx | nx``, ``K <= nyl`` and the persistent pass's
    windows within a block's shared memory; its kernel runs
    :attr:`nblocks` persistent blocks, as :class:`TemporalXtStep`'s.

    The :class:`ShardProgram` contract with ``(f, ghost)`` in place of the
    ping-pong pair: ``launch = bind(f, ghost, sums)`` fills the bands from
    f; ``launch(i)`` advances f in place and writes ``sums[i*K : (i+1)*K]``,
    the slab's unscaled |u| sums.  :meth:`bind_carry` binds a carry made
    before (:meth:`init`), its launch's ``prologue`` filling the bands of
    parity 0 from f, as :class:`TemporalXtStep`'s.  Its plain version
    (:meth:`bind_plain`, :meth:`plain_launch`) is the band algorithm in
    torch on the slab and its ghost rows."""

    kernel = "lbm_shard_temporal_xt_step"
    shard_entry = True

    def __init__(self, params, mask_ext: np.ndarray, layout, row0: int, free_cells_inv,
                 device, by: int, bx: int) -> None:
        k, nyl = layout.halo, layout.nyl
        if mask_ext.shape != (nyl + 2 * k, params.nx) or mask_ext.dtype != np.uint8:
            raise ValueError(f"padded mask must be uint8 {(nyl + 2 * k, params.nx)}, got "
                             f"{mask_ext.dtype} {mask_ext.shape}")
        if not 0 <= row0 <= params.ny - nyl:
            raise ValueError(f"shard rows [{row0}, {row0 + nyl}) outside the grid's "
                             f"{params.ny}")
        _check_footprint(by, bx, k)
        device = torch.device(device)
        self._lib = None if device.type == "cpu" else _build.load_library()
        torch.nn.Module.__init__(self)
        self.params, self.layout = params, layout
        self.register_buffer("mask_ext", torch.as_tensor(mask_ext, device=device))
        self.register_buffer("fluid", self.mask_ext[k:k + nyl].clone())
        self._init_tiles(nyl, row0, by, bx, k, 1, free_cells_inv, device)
        self._av_scale = 1.0  # the shard's unscaled sums

    def bind(self, f: torch.Tensor, ghost: torch.Tensor, sums: torch.Tensor):
        """``launch(i)``: one pass of ``f`` in place, the ghost rows from
        ``ghost``; CUDA tensors launch the kernel, CPU tensors take the
        plain version."""
        return self.bind_carry(self.init(f), ghost, sums)

    def bind_carry(self, carry: BandCarry, ghost: torch.Tensor, sums: torch.Tensor,
                   plain: bool = False):
        """As :meth:`bind`, on ``carry`` (``plain``: the plain version on
        any device)."""
        if plain or runs_plain(carry.f):
            launch = self._plain_launcher(carry, ghost, sums)
        else:
            launch = self._shard_launcher(carry, ghost, sums)
        launch.prologue = (lambda: self.restart(carry),)
        return launch

    def _shard_launcher(self, carry: BandCarry, ghost: torch.Tensor, sums: torch.Tensor):
        f = carry.f
        self._check_carry(carry, sums)
        dev = self.fluid.device
        if (ghost.dtype != torch.float32 or tuple(ghost.shape) != self.layout.ghost_shape
                or not ghost.is_contiguous() or ghost.device != dev):
            raise ValueError(f"ghost must be contiguous float32 {self.layout.ghost_shape} "
                             f"on {dev}")
        lib = _build.load_library()
        f_ptr, g_ptr = f.data_ptr(), ghost.data_ptr()
        bands = (carry.bands[0].data_ptr(), carry.bands[1].data_ptr())
        mask, partials = self.mask_ext.data_ptr(), self.partials.data_ptr()
        consts = ctypes.addressof(self._consts)
        s0, n, k = sums.data_ptr(), sums.numel(), self.ksteps
        args = (self.rows, self.row0, self.by, self.bx, k, self.nblocks)
        stream = torch.cuda.current_stream(f.device).cuda_stream

        def launch(i: int) -> None:
            self._check_launch(i, n)
            p = carry.parity
            _launch(lib, self.kernel, f_ptr, g_ptr, bands[p], bands[p ^ 1], mask, partials,
                    s0 + 4 * i * k, consts, *args, stream)
            carry.parity = p ^ 1

        return launch

    def bind_plain(self, f: torch.Tensor, ghost: torch.Tensor, sums: torch.Tensor):
        """As :meth:`bind`, the plain version on any device."""
        return self.bind_carry(self.init(f), ghost, sums, plain=True)

    def _plain_launcher(self, carry: BandCarry, ghost: torch.Tensor, sums: torch.Tensor):
        n, k = sums.numel(), self.ksteps

        def launch(i: int) -> None:
            self._check_launch(i, n)
            self._plain_pass(carry, sums[i * k:(i + 1) * k], ghost, self.mask_ext)

        return launch

    def plain_launch(self, f: torch.Tensor,
                     ghost: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One pass in plain torch from ``f`` (not modified) and its ghost
        rows, the bands filled from f: ``(f', sums[K])``."""
        sums = torch.empty(self.ksteps, dtype=torch.float32, device=f.device)
        carry = self.init(f.clone())
        self._plain_launcher(carry, ghost, sums)(0)
        return carry.f, sums

"""The schedule choice: which kernel, and at what chunk or tile, runs a
grid for a given number of steps.

Port of ``lbm_tpu.ops.fused``'s ``pick_chunk``, ``choose_temporal`` /
``choose_temporal_xtiled`` / ``choose_schedule`` and
``make_fused_program``, with the JAX branch order:

1. the multi-step kernel, ``pick_chunk(max_iters)`` steps per launch, for
   grids within :data:`MULTISTEP_CELL_BUDGET` when that chunk is > 1:
   :class:`MultiStep` runs it across the card's SMs in bands of rows held
   in shared memory, their edge rows handed off through L2
   (:func:`bands_plan`, :func:`bands_admission`), where each band is one
   chunk of its sweep; else with a grid barrier (:func:`multi_route`);
2. where the ping-pong pair fits the device (``pingpong_fits``), the
   measured tuning cache (:mod:`lbm_tpu_torch.tuning`, written by ``lbm
   autotune``): its first entry, of either schedule, whose tile and K the
   kernel takes;
3. where it does not, the x-tiled (in-place) kernel for giant widths,
   where ``lbm_tpu``'s gate admits the grid (:func:`choose_temporal_xtiled`,
   which reads the cache's x-tiled entries first);
4. else the temporal kernel, K steps per pass, where a tiling exists with
   K dividing ``max_iters`` (:func:`choose_temporal`);
5. else the one-step kernel, which takes any grid and any step count.

The cache is keyed by the name of the device the run is on
(``device_kind``; by default the current CUDA device's, ``"cpu"``
without one), as ``lbm_tpu``'s is by its device kind.

The thresholds are Hopper's, not the TPU's VMEM budgets: the multi-step
budget is what keeps its state in L2, and the temporal tile (x-tiled or
not) is what fits a block's shared memory.  On the TPU the row temporal
kernel cannot take a width of 8192 (its row window outgrows VMEM), so
``lbm_tpu`` sends every admitted grid to the x-tiled kernel.  Here the
temporal kernel's 2-D tiles take any width and run faster than the
in-place pass (0.9742 against 1.6631 ms a step at 8192^2 on an NVIDIA
H100 80GB HBM3, 700 W, ``chip_smoke.py``; PERF.md), so the in-place
kernel is taken only for what it saves: a quarter of f in device memory,
where the ping-pong pair would not fit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lbm_tpu_torch import tuning
from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.ops import _build
from lbm_tpu_torch.ops.fused import (
    BYTES_PER_CELL,
    FusedStep,
    MultiStep,
    StepProgram,
    TemporalStep,
    TemporalXtStep,
)

# The H100's L2 is 50 MB (NVIDIA's data sheet).  The multi-step kernel
# reads and writes both f buffers every step, so the grids it takes are
# those whose two buffers and mask (73 B per cell) fit in it: up to 512^2
# of the power-of-two squares.
L2_BYTES = 50 * 2**20
MULTISTEP_CELL_BUDGET = L2_BYTES // BYTES_PER_CELL

def even_bands(ny: int, blocks: int) -> list[tuple[int, int]]:
    """``(row0, rows)`` of each block's band: ``ny // blocks`` rows, one
    more for the first ``ny % blocks`` blocks (``band_of`` in the C
    source)."""
    h, extra = divmod(ny, blocks)
    return [(r * h + min(r, extra), h + (r < extra)) for r in range(blocks)]


# The multi-step kernel across the card (``csrc/lbm_multi_bands.cu``): one
# block an SM (its dynamic shared memory padded above half an SM's), each
# holding a band of whole rows in shared memory within the 227 KB opt-in
# maximum less 1 KiB for its static memory.  A block has at most
# BANDS_MAX_THREADS threads, one a cell (so nx may not exceed it; a band of
# more cells is swept in chunks), which leaves a thread 128 registers.  The
# plain version on the CPU takes the SMs of an H100 SXM.
BANDS_MAX_THREADS = 512
BANDS_SMEM_BUDGET = 232_448 - 1024
BANDS_CPU_BLOCKS = 132
# A slot of the handoff holds BANDS_SLOT_POPS populations of a row, in two
# parities and two sides a block (``kSlotPops``).
BANDS_SLOT_POPS = 5
# The most chunks of its sweep a band of the bands kernel's route may take
# (:func:`multi_route`).
BANDS_MAX_CHUNKS = 1
# The widths the bands kernel's one-chunk step is compiled for
# (``width_of``): the small canonical grids'.
BANDS_STEP_WIDTHS = (128, 256)


def bands_threads(ny: int, nx: int, blocks: int) -> int:
    """Threads of a block of the bands kernel (``threads_of`` in the C
    source): one a cell of the widest band, in whole warps, at least one
    row's and at most :data:`BANDS_MAX_THREADS`."""
    hmax = -(-ny // blocks)
    return min(BANDS_MAX_THREADS, max(-(-nx // 32) * 32, -(-hmax * nx // 32) * 32))


def bands_width(ny: int, nx: int, blocks: int) -> int:
    """The width the bands kernel's step is compiled for (``width_of`` in
    ``csrc/lbm_multi_bands.cu``): ``nx`` where it is one of
    :data:`BANDS_STEP_WIDTHS` and the widest band is one chunk (its cells
    fit :data:`BANDS_MAX_THREADS` threads), which takes the one-chunk step;
    else 0, the general step."""
    hmax = -(-ny // blocks)
    return nx if nx in BANDS_STEP_WIDTHS and hmax * nx <= BANDS_MAX_THREADS else 0


def bands_smem_bytes(ny: int, nx: int, blocks: int) -> int:
    """Dynamic shared memory of one block's footprint in the bands kernel
    (``smem_bytes`` in ``csrc/lbm_multi_bands.cu``).  The one-chunk step
    (:func:`bands_width`): two copies of the widest band's rows and its two
    ghost rows, 9 fp32 planes each, and the uint8 mask of those rows.  The
    general step: the widest band's rows, two ghost rows and two saved rows
    of 9 fp32 planes, and the uint8 mask of the band and its two ghost
    rows."""
    hmax = -(-ny // blocks)
    if bands_width(ny, nx, blocks):
        return (2 * 9 * nx * 4 + nx) * (hmax + 2)
    return 9 * nx * 4 * (hmax + 4) + (hmax + 2) * nx


def bands_plan(ny: int, nx: int,
               max_blocks: int) -> tuple[int, list[tuple[int, int]], int, int] | None:
    """``(G, bands, threads, smem_bytes)`` of the bands kernel for an ``ny x
    nx`` grid on a card of ``max_blocks`` SMs, else None: the fewest blocks
    that give the thinnest bands ``max_blocks`` allow (``G = ceil(ny /
    ceil(ny / min(max_blocks, ny)))``: even bands where they can be), from
    the footprint alone (:func:`bands_smem_bytes` within
    :data:`BANDS_SMEM_BUDGET`, ``nx <= BANDS_MAX_THREADS``)."""
    if ny < 2 or max_blocks < 1 or not 1 <= nx <= BANDS_MAX_THREADS:
        return None
    hmax = -(-ny // min(max_blocks, ny))
    g = -(-ny // hmax)
    smem = bands_smem_bytes(ny, nx, g)
    if smem > BANDS_SMEM_BUDGET:
        return None
    return g, even_bands(ny, g), bands_threads(ny, nx, g), smem


def bands_chunks(ny: int, nx: int, blocks: int) -> int:
    """Chunks a step of the bands kernel sweeps in its widest band."""
    hmax = -(-ny // blocks)
    return -(-hmax // (bands_threads(ny, nx, blocks) // nx))


@functools.cache
def _card_sms(index: int) -> int:
    n = _build.load_library().lbm_sm_count(index)
    if n < 1:
        raise RuntimeError(f"cudaDevAttrMultiProcessorCount failed on cuda:{index}")
    return n


def bands_admission(device: torch.device) -> int:
    """The blocks the bands kernel may take on ``device``: its SMs (asked
    once per process and device; the cooperative launch refuses a grid the
    card does not hold at once).  On the CPU, :data:`BANDS_CPU_BLOCKS`."""
    device = torch.device(device)
    if device.type == "cpu":
        return BANDS_CPU_BLOCKS
    return _card_sms(device.index if device.index is not None else
                     torch.cuda.current_device())


def multi_route(ny: int, nx: int, max_blocks: int) -> str:
    """``"bands"`` or ``"grid"``: which multi-step kernel runs an ``ny x
    nx`` grid on a card of ``max_blocks`` SMs.  The bands kernel where the
    grid fits its plan (:func:`bands_plan`) in one chunk a band
    (:data:`BANDS_MAX_CHUNKS`), else the grid-barrier kernel: rows wider
    than :data:`BANDS_MAX_THREADS`, and bands of several chunks (e.g.
    512^2: four chunks a band on 128 blocks, not timed).

    On an NVIDIA H100 80GB HBM3 (700 W), in turns from one state at chunk
    200 (``chip_smoke.py`` phase 3, PERF.md §6), µs a step of the bands and
    grid kernels: 64x96 1.640, 3.210 (1-row bands); 37x75 1.644, 4.170;
    128^2 1.150 (the bands kernel's one-chunk step), 3.160; 128x256 1.185,
    3.246; 256^2 1.575, 3.741; the handoff alone 0.738 (rows 128 wide)."""
    bands = bands_plan(ny, nx, max_blocks)
    if bands is not None and bands_chunks(ny, nx, bands[0]) <= BANDS_MAX_CHUNKS:
        return "bands"
    return "grid"


# Dynamic shared memory a block of a persistent pass (every window kernel:
# the temporal, 16-bit, x-tiled and mega kernels and the shard entries) may
# take: the H100's 227 KB opt-in maximum per block (232,448 bytes), less its
# two slots of the |u| tree's 512 values (`lbm::kPassSmemBudget`,
# csrc/lbm_persistent.cuh).
PERSISTENT_SMEM_BUDGET = 232_448 - 2 * 512 * 4

# Preference orders of the temporal schedule: K first, then the tile
# (by, bx); the first whose windows fit wins.  Larger K moves fewer bytes
# per step but computes more of the halo again.  Set from chip_smoke.py's
# 1024^2 sweep of the persistent kernel (PERF.md), by CUDA events in one
# run on an NVIDIA H100 80GB HBM3 at 700 W: 32x64 at K 4 took 20.71 us a
# step, 64x32 21.04, 32x32 at K 8 22.73, 32x32 at K 4 23.22, 16x32 at K 4
# 23.38; at K 2 the best, 16x32, 27.46.  The x-tiled kernel takes the same
# order with the same footprint (:func:`persistent_fits`).
TEMPORAL_K = (4, 8, 2)
TEMPORAL_TILES = ((32, 64), (64, 32), (32, 32), (16, 32), (16, 16), (8, 8))


def pick_chunk(max_iters: int, limit: int = 256) -> int:
    """Largest divisor of ``max_iters`` not exceeding ``limit``, a
    multiple of 8 where one exists (``lbm_tpu.ops.fused.pick_chunk``)."""
    best_any = 1
    for c in range(min(limit, max_iters), 0, -1):
        if max_iters % c == 0:
            if c % 8 == 0:
                return c
            best_any = max(best_any, c)
    return best_any


def persistent_smem_bytes(by: int, bx: int, ksteps: int) -> int:
    """Dynamic shared memory of one block of a persistent pass (every
    window kernel, ``lbm::pass_smem_bytes`` in
    ``csrc/lbm_persistent.cuh``): two fp32 window buffers of 9 planes and
    two uint8 mask windows (the current tile's and the next one's); the
    16-bit kernel stages its 16-bit copies inside the fp32 buffers."""
    window = (by + 2 * ksteps) * (bx + 2 * ksteps)
    return 2 * 9 * 4 * window + 2 * window


def persistent_fits(by: int, bx: int, ksteps: int) -> bool:
    """Whether a block of a persistent pass fits at this tile
    (:data:`PERSISTENT_SMEM_BUDGET`)."""
    return persistent_smem_bytes(by, bx, ksteps) <= PERSISTENT_SMEM_BUDGET


def _cached(ny: int, nx: int, max_iters: int, device_kind: str | None,
            schedules: tuple[str, ...]) -> tuple[str, tuple[int, int, int]] | None:
    """The first entry of the tuning cache for this device and grid whose
    schedule is one of ``schedules`` and whose tile and K that schedule's
    kernel takes (:func:`structurally_valid`); None when there is none."""
    if device_kind is None:
        device_kind = tuning.default_device_kind()
    for by, bx, k, sched in tuning.lookup(device_kind, ny, nx):
        if sched in schedules and structurally_valid(sched, ny, nx, by, bx, k, max_iters):
            return sched, (by, bx, k)
    return None


def choose_temporal(ny: int, nx: int, max_iters: int,
                    device_kind: str | None = None) -> tuple[int, int, int] | None:
    """``(by, bx, K)`` for the temporal kernel: the first measured
    ``"temporal"`` entry of the tuning cache that the kernel takes, else
    :func:`fixed_temporal`."""
    hit = _cached(ny, nx, max_iters, device_kind, ("temporal",))
    return hit[1] if hit is not None else fixed_temporal(ny, nx, max_iters)


def fixed_temporal(ny: int, nx: int, max_iters: int) -> tuple[int, int, int] | None:
    """The fixed order of the temporal and x-tiled kernels: the first K of
    :data:`TEMPORAL_K` that divides ``max_iters`` and has a tile, with the
    first tile of :data:`TEMPORAL_TILES` that divides the grid and whose
    windows fit a block (:func:`persistent_fits`); None when none does."""
    for ksteps in TEMPORAL_K:
        if max_iters % ksteps:
            continue
        for by, bx in TEMPORAL_TILES:
            if ny % by == 0 and nx % bx == 0 and persistent_fits(by, bx, ksteps):
                return by, bx, ksteps
    return None


# lbm_tpu's x-tiled gate: widths from this one up, grids of at least
# XTILED_MIN_NY rows (``choose_temporal_xtiled``, lbm_tpu/ops/fused.py).
XTILED_MIN_NX = 8192
XTILED_MIN_NY = 16


def xtiled_strips(nx: int) -> list[int]:
    """``lbm_tpu``'s strip counts for width nx: Px >= 2 dividing nx into
    strips of a whole number of 128 columns, at least 1024 wide."""
    return [p for p in range(2, nx // 1024 + 1) if nx % p == 0 and (nx // p) % 128 == 0]


def xtiled_structurally_valid(ny: int, nx: int, by: int, bx: int, ksteps: int,
                              max_iters: int) -> bool:
    """The x-tiled kernel's hard constraints on Hopper (the port of
    ``_xtiled_structurally_valid``): the tile divides the grid, K divides
    ``max_iters``, and the windows fit a block's shared memory
    (:func:`persistent_fits`).  Unlike the TPU kernel it needs no K <= BY-2 and
    no lane-aligned strips."""
    return structurally_valid("xtiled", ny, nx, by, bx, ksteps, max_iters)


def structurally_valid(schedule: str, ny: int, nx: int, by: int, bx: int, ksteps: int,
                       max_iters: int) -> bool:
    """Whether the kernel of ``schedule`` (``"temporal"`` or ``"xtiled"``)
    takes this tile and K: the tile divides the grid, K divides
    ``max_iters``, and the persistent pass's shared memory fits a block
    (:func:`persistent_fits`; both kernels run it)."""
    return (by >= 1 and bx >= 1 and ksteps >= 1 and ny % by == 0 and nx % bx == 0
            and max_iters % ksteps == 0 and persistent_fits(by, bx, ksteps))


def choose_temporal_xtiled(ny: int, nx: int, max_iters: int,
                           device_kind: str | None = None) -> tuple[int, int, int] | None:
    """``(by, bx, K)`` for the x-tiled kernel, or None where ``lbm_tpu``
    keeps plain row blocking: its gate (nx >= 8192, ny >= 16, and a strip
    width of a multiple of 128 columns that divides nx, :func:`xtiled_strips`)
    decides whether.  The tile is the first measured ``"xtiled"`` entry
    of the tuning cache that the kernel takes, else the fixed order's
    (:func:`fixed_temporal`: the persistent pass's footprint)."""
    if nx < XTILED_MIN_NX or ny < XTILED_MIN_NY or not xtiled_strips(nx):
        return None
    hit = _cached(ny, nx, max_iters, device_kind, ("xtiled",))
    if hit is not None:
        return hit[1]
    return fixed_temporal(ny, nx, max_iters)


def choose_schedule(
    ny: int, nx: int, max_iters: int | None, *, pingpong_fits: bool = True,
    device_kind: str | None = None,
) -> tuple[str, tuple[int, ...]]:
    """``("multi", (chunk,))``, ``("xtiled", (by, bx, K))``, ``("temporal",
    (by, bx, K))`` or ``("fused", ())`` for an ``ny x nx`` grid run for
    ``max_iters`` steps (None: unknown, which takes the one-step kernel),
    in the module docstring's order.  ``pingpong_fits`` says whether the
    device holds the two f buffers of a ping-pong run; where it does not,
    the x-tiled kernel takes the grids ``lbm_tpu``'s gate admits."""
    if max_iters is not None and ny * nx <= MULTISTEP_CELL_BUDGET and max_iters > 1:
        chunk = pick_chunk(max_iters)
        if chunk > 1:
            return "multi", (chunk,)
    if max_iters is not None:
        if pingpong_fits:
            hit = _cached(ny, nx, max_iters, device_kind, tuning.SCHEDULES)
            if hit is not None:
                return hit
        else:
            picked = choose_temporal_xtiled(ny, nx, max_iters, device_kind)
            if picked is not None:
                return "xtiled", picked
        picked = choose_temporal(ny, nx, max_iters, device_kind)
        if picked is not None:
            return "temporal", picked
    return "fused", ()


def make_fused_program(
    params: LBMParams,
    obstacles: np.ndarray,
    free_cells_inv: np.float32,
    device: torch.device,
    *,
    max_iters: int | None = None,
    pingpong_fits: bool = True,
    device_kind: str | None = None,
) -> StepProgram:
    """The step program :func:`choose_schedule` picks for ``params``'
    grid and ``max_iters`` steps; its ``chunk`` divides ``max_iters``."""
    kind, args = choose_schedule(params.ny, params.nx, max_iters,
                                 pingpong_fits=pingpong_fits, device_kind=device_kind)
    if kind == "multi":
        return MultiStep(params, obstacles, free_cells_inv, device, *args)
    if kind == "xtiled":
        return TemporalXtStep(params, obstacles, free_cells_inv, device, *args)
    if kind == "temporal":
        return TemporalStep(params, obstacles, free_cells_inv, device, *args)
    return FusedStep(params, obstacles, free_cells_inv, device)

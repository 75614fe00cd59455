"""Row and 2-D sharding: the grid split over a mesh of shards, each shard
a halo-padded tile with its own kernel launches, the halos exchanged
between shards before each launch.

The port of ``lbm_tpu.parallel.sharded``.  ``lbm_tpu`` runs the whole
sharded time loop as one SPMD program (``shard_map``); here each process
drives the shards of the mesh it owns (all of them without a process
group, :mod:`lbm_tpu_torch.parallel.dist`), each on its device's current
stream, in the order exchange, launch, for every launch of the run, and
syncs once at the end.  Every process of a group runs the same program:
the exchange trades the pieces that cross processes, card to card where
every process runs on one host with CUDA shards (CUDA IPC), else over the
gloo group (:func:`choose_transport`).
A 1-D mesh is a 2-D one with one column of shards: both pad the tile in x
and exchange x halos (a shard's own opposite edge when px is 1), so the
same kernels serve both.  The x-tiled route keeps each shard's rows
unpadded instead and updates them in place, with only K ghost rows each
way crossing shards before each pass (``parallel/halo.py``).

* The factories under ``lbm_tpu``'s names build one :class:`ShardedProgram`
  each: ``make_sharded_run`` / ``make_sharded_2d_run`` (the plain torch
  step per shard, any device), ``make_sharded_fused_run`` /
  ``make_sharded_fused_2d_run`` (the shard one-step kernel) and
  ``make_sharded_temporal_run`` / ``make_sharded_temporal_2d_run`` (the
  shard temporal kernel, K steps per exchange, the local (BY, BX, K) from
  :func:`lbm_tpu_torch.ops.schedule.choose_temporal` on the shard tile;
  None where it admits none) and ``make_sharded_temporal_xt_run`` (the
  shard x-tiled kernel on row slabs, which the temporal factories route to
  as ``lbm_tpu``'s do).
* :class:`ShardedSimulator` routes as ``lbm_tpu``'s does and runs, times
  and reads back a sharded run, checkpointed or not.

f of a sharded run equals f of a single-device run bit for bit: every
cell runs ``lbm::update_cell`` (or the plain step) on the same values.
av is each shard's |u| sum per step (one fixed-order reduction per shard,
no float atomics), added over the shards in mesh order and scaled by
1/free_cells, so it differs from a single-device av only in the order of
the sum.  One process adds on its first shard's device; a group gathers
every process's sums and adds them on the host in the same order, and
fp32 elementwise adds give the same bits on either, so one mesh's av is
the same bits over one process or several.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import time
from typing import Callable

import numpy as np
import torch

from lbm_tpu_torch import checkpoint as ckpt
from lbm_tpu_torch import diagnostics, runtime, tuning
from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.geometry import free_cells_of
from lbm_tpu_torch.ops import _build, schedule
from lbm_tpu_torch.ops.fused import (
    ShardProgram,
    ShardStep,
    ShardTemporalStep,
    ShardTemporalXtStep,
)
from lbm_tpu_torch.ops.lattice import NSPEEDS
from lbm_tpu_torch.ops.reference import uniform_weights
from lbm_tpu_torch.parallel import dist
from lbm_tpu_torch.parallel.halo import (
    GhostExchange,
    GroupTransport,
    HaloExchange,
    SlabLayout,
    TileLayout,
)
from lbm_tpu_torch.parallel.ipc import DeviceTransport
from lbm_tpu_torch.parallel.mesh import AXIS_X, Mesh, default_mesh
from lbm_tpu_torch.runtime import (
    check_readback,
    expand_fields,
    raw_fields_fn,
    run_segments_checkpointed,
)
from lbm_tpu_torch.utils import debugging


def _guard(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


# Why a run over several processes reads back neither f nor the fields
# (``lbm_tpu``'s reason): both gather the global f in one process.
SINGLE_CONTROLLER = ("state/fields readbacks gather the global f and are "
                     "single-controller only; a run over several processes reads "
                     "back 'device' (its own shards) or checkpoints per shard")


@dataclasses.dataclass
class ShardedState:
    """f of a sharded run left on the shards' devices: the owned cells of
    this process's shards' final buffers (views), by mesh position, and
    where they sit in the global grid; ``positions`` lists every shard of
    the mesh, this process's or not, as ``(y0, x0, shape)`` (by default the
    tiles')."""

    tiles: list[tuple[int, int, torch.Tensor]]  # (y0, x0, [9, nyl, nxl])
    shape: tuple[int, int, int]
    positions: list[tuple[int, int, tuple[int, int, int]]] | None = None

    def __post_init__(self) -> None:
        if self.positions is None:
            self.positions = [(y0, x0, tuple(t.shape)) for y0, x0, t in self.tiles]

    @property
    def complete(self) -> bool:
        """Whether this process holds every shard."""
        return len(self.tiles) == len(self.positions)

    def shards(self):
        """``(y0, x0, host slab)`` per shard of this process (what
        ``save_sharded`` writes)."""
        for y0, x0, t in self.tiles:
            yield y0, x0, t.cpu().numpy()

    def cpu(self) -> torch.Tensor:
        """The global f gathered on the host (this process must hold every
        shard)."""
        if not self.complete:
            raise RuntimeError(SINGLE_CONTROLLER)
        out = torch.empty(self.shape, dtype=torch.float32)
        for y0, x0, t in self.tiles:
            out[:, y0:y0 + t.shape[1], x0:x0 + t.shape[2]] = t.cpu()
        return out


class ShardedProgram:
    """One sharded run of ``max_iters`` steps: a shard program per mesh
    position this process owns (``make_shard(fluid_pad, row0, device)``;
    ``shards[iy][ix]`` is None at another process's), their padded
    ping-pong buffers, and the halo exchange.  ``chunk`` steps per launch;
    launch ``i`` exchanges the halos of the buffers of parity ``i & 1``,
    then launches every shard.  Callable as ``lbm_tpu``'s factories' runs
    are: ``program(f0) -> (f, av)`` on the host (one process only)."""

    def __init__(self, params: LBMParams, obstacles: np.ndarray, free_cells_inv,
                 mesh: Mesh, max_iters: int, layout: TileLayout,
                 make_shard: Callable[[np.ndarray, int, torch.device], ShardProgram],
                 variant: str) -> None:
        self.params, self.mesh, self.layout, self.variant = params, mesh, layout, variant
        self.max_iters = max_iters
        self.fcinv = float(np.float32(free_cells_inv))
        if mesh.processes != list(range(dist.process_count())):
            raise ValueError(f"a mesh over processes {mesh.processes} in a run of "
                             f"{dist.process_count()}: every process must own shards "
                             "(default_mesh and default_mesh_2d span them all)")
        fluid = ~np.asarray(obstacles, dtype=bool)
        local = set(mesh.local_positions())
        self.shards = [
            [make_shard(layout.pad_mask(fluid, iy * layout.nyl, ix * layout.nxl),
                        iy * layout.nyl, mesh.device(iy, ix)) if (iy, ix) in local else None
             for ix in range(mesh.px)]
            for iy in range(mesh.py)]
        first = next(p for row in self.shards for p in row if p is not None)
        self.chunk, self.bytes_per_update = first.chunk, first.bytes_per_update
        if max_iters % self.chunk:
            raise ValueError(f"{self.chunk} steps per launch do not divide "
                             f"max_iters={max_iters}")
        self.devices = sorted({str(d) for d in mesh.local_devices()})
        self.device0 = first.fluid.device
        self.transport_kind = choose_transport(mesh)
        self._transport = None

    def positions(self):
        """``(y0, x0, shard program)`` of this process's shards, in mesh
        order."""
        lay = self.layout
        for iy, row in enumerate(self.shards):
            for ix, prog in enumerate(row):
                if prog is not None:
                    yield iy * lay.nyl, ix * lay.nxl, prog

    def global_positions(self) -> list[tuple[int, int, tuple[int, int, int]]]:
        """``(y0, x0, owned shape)`` of every shard of the mesh, in mesh
        order."""
        lay = self.layout
        shape = (NSPEEDS, lay.nyl, lay.nxl)
        return [(iy * lay.nyl, ix * lay.nxl, shape)
                for iy in range(self.mesh.py) for ix in range(self.mesh.px)]

    def alloc(self) -> tuple[list, list]:
        """Each of this process's shards' two buffers
        (``layout.buffer_shapes``: the padded ping-pong pair) and its sums
        vector, on its device (the halos are filled before every launch);
        None at another process's positions."""
        bufs = [[None if p is None else
                 [torch.empty(shape, dtype=torch.float32, device=p.fluid.device)
                  for shape in self.layout.buffer_shapes] for p in row]
                for row in self.shards]
        sums = [[None if p is None else
                 torch.zeros(self.max_iters, dtype=torch.float32, device=p.fluid.device)
                 for p in row] for row in self.shards]
        return bufs, sums

    def _local(self, grid) -> list:
        """The entries of a ``[py][px]`` grid at this process's positions,
        in mesh order."""
        return [x for row, prow in zip(grid, self.shards)
                for x, p in zip(row, prow) if p is not None]

    def upload(self, bufs, f0=None) -> None:
        """The owned cells of every shard's first buffer from the global
        ``f0`` (a host array or tensor, or a :class:`ShardedState`), or
        from the uniform initial state."""
        lay = self.layout
        w = torch.as_tensor(uniform_weights(self.params))
        if isinstance(f0, ShardedState):
            f0 = {(y0, x0): t for y0, x0, t in f0.tiles}
        elif f0 is not None:
            if not isinstance(f0, torch.Tensor):
                f0 = torch.from_numpy(np.asarray(f0, dtype=np.float32))
            if tuple(f0.shape) != (NSPEEDS, self.params.ny, self.params.nx):
                raise ValueError(f"f0 must be {(NSPEEDS, self.params.ny, self.params.nx)},"
                                 f" got {tuple(f0.shape)}")
        for (y0, x0, prog), buf in zip(self.positions(), self._local(bufs)):
            dst = lay.interior(buf[0])
            if f0 is None:
                src = w.to(dst.device)[:, None, None].expand(dst.shape)
            elif isinstance(f0, dict):
                src = f0[(y0, x0)]
            else:
                src = f0[:, y0:y0 + lay.nyl, x0:x0 + lay.nxl]
            dst.copy_(src)

    def transport(self):
        """The transport of the pieces that cross processes
        (:attr:`transport_kind`), made once: None with one process, the gloo
        group, or a :class:`DeviceTransport` on this process's card."""
        if self._transport is None and self.transport_kind != "local":
            self._transport = (DeviceTransport(self.device0) if self.transport_kind == "ipc"
                               else GroupTransport())
        return self._transport

    def exchanges(self, bufs, transport=None) -> list:
        """The exchanges launch ``i`` runs (``i`` modulo their number): the
        halos of the buffers of parity ``i & 1``, over ``transport`` (by
        default the program's)."""
        t = self.transport() if transport is None else transport
        return [HaloExchange([[None if b is None else b[p] for b in row] for row in bufs],
                             self.layout, self.mesh.procs, transport=t)
                for p in (0, 1)]

    def bind(self, bufs, sums, plain: bool = False):
        """``launch(i)``: the halo exchange of the buffers launch ``i``
        reads, then every shard's launch ``i``, each run of consecutive
        shards on one device under one device guard (one guard a launch
        when every shard sits on one card).  ``plain`` binds every shard's
        plain version, on any device (what the kernels are held against on
        the card)."""
        exchanges = self.exchanges(bufs)
        calls = []
        for prog, b, s in zip(self._local(self.shards), self._local(bufs),
                              self._local(sums)):
            dev = prog.fluid.device
            with _guard(dev):  # a shard binds on its own device
                calls.append((dev, (prog.bind_plain if plain else prog.bind)(
                    b[0], b[1], s)))
        groups = _by_device(calls)

        def launch(i: int) -> None:
            exchanges[i % len(exchanges)]()
            for dev, fns in groups:
                with _guard(dev):
                    for fn in fns:
                        fn(i)

        return launch

    def final_index(self, n_launches: int) -> int:
        return n_launches & 1

    def state(self, bufs, n_launches: int) -> ShardedState:
        k = self.final_index(n_launches)
        tiles = [(y0, x0, self.layout.interior(b[k]))
                 for (y0, x0, _), b in zip(self.positions(), self._local(bufs))]
        return ShardedState(tiles, (NSPEEDS, self.params.ny, self.params.nx),
                            self.global_positions())

    def av(self, sums) -> torch.Tensor:
        """Every shard's sums added in mesh order, times 1/free_cells, on
        the first local shard's device: on it where this process holds
        every shard; else every process's sums gathered over the group
        and added on the host."""
        local = self._local(sums)
        if dist.process_count() == 1:
            flat = [s.to(self.device0) for s in local]
            return functools.reduce(torch.add, flat) * self.fcinv
        gathered = dist.all_gather_object(torch.stack([s.cpu() for s in local]).numpy())
        by_pos = {pos: torch.from_numpy(rows[i]) for proc, rows in enumerate(gathered)
                  for i, pos in enumerate(self.mesh.positions_of(proc))}
        flat = [by_pos[(iy, ix)] for iy in range(self.mesh.py) for ix in range(self.mesh.px)]
        return (functools.reduce(torch.add, flat) * self.fcinv).to(self.device0)

    def run(self, f0=None, launches: int | None = None,
            plain: bool = False) -> tuple[ShardedState, torch.Tensor]:
        """``launches`` launches (all of the run's by default) from the
        global ``f0`` (see :meth:`upload`): fresh buffers, the upload, the
        launches (``plain``: every shard's plain version).  Returns the
        final state on the shards and the av of those steps on the first
        shard's device."""
        n = self.max_iters // self.chunk if launches is None else launches
        with _guard(self.device0):
            bufs, sums = self.alloc()
            self.upload(bufs, f0)
            launch = debugging.guarded(self.bind(bufs, sums, plain=plain), lambda i: (
                [("f", t) for *_, t in self.state(bufs, i + 1).tiles]
                + [("av", s) for s in self._local(sums)]))
            for i in range(n):
                launch(i)
            return self.state(bufs, n), self.av(sums)[:n * self.chunk]

    def __call__(self, f0=None) -> tuple[torch.Tensor, torch.Tensor]:
        """``run(f_global) -> (f_final_global, av_vels)`` on the host, as
        ``lbm_tpu``'s factories return it (``f0`` None: the uniform
        state)."""
        state, av = self.run(f0)
        return state.cpu(), av.cpu()


class ShardedXtProgram(ShardedProgram):
    """A sharded run of the shard x-tiled kernel: each shard binds its row
    slab f and its ghost rows (:class:`SlabLayout`), f is updated in place
    (the state stays in buffer 0), and every launch first fills every
    slab's ghost rows from its neighbours' f (:class:`GhostExchange`),
    before any shard's launch of that pass."""

    def exchanges(self, bufs, transport=None) -> list:
        t = self.transport() if transport is None else transport
        return [GhostExchange([None if row[0] is None else (row[0][0], row[0][1])
                               for row in bufs], self.layout, self.mesh.procs,
                              transport=t)]

    def final_index(self, n_launches: int) -> int:
        return 0


def _by_device(calls: list) -> list[tuple[torch.device, list]]:
    """``(device, fns)`` pairs in order, each the run of consecutive
    ``(device, fn)`` calls on one device."""
    groups: list[tuple[torch.device, list]] = []
    for dev, fn in calls:
        if groups and groups[-1][0] == dev:
            groups[-1][1].append(fn)
        else:
            groups.append((dev, [fn]))
    return groups


def choose_transport(mesh: Mesh) -> str:
    """How the pieces that cross processes travel, by topology: ``"local"``
    with one process (none crosses); ``"ipc"`` (card to card,
    :class:`DeviceTransport`) where every process of the group runs on this
    host and this process's shards share one CUDA device; else ``"gloo"``
    (staged through host buffers).  Not a fallback: the device transport
    raises where it cannot open or launch."""
    if dist.process_count() == 1:
        return "local"
    devices = set(mesh.local_devices())
    one_card = len(devices) == 1 and next(iter(devices)).type == "cuda"
    return "ipc" if one_card and len(set(dist.hostnames())) == 1 else "gloo"


def _same_route(program: ShardedProgram) -> None:
    """Raise unless every process of the group took the same route: the
    variant, its steps per launch, the layout, the shard program with its
    tiling and the transport (one process: nothing to compare)."""
    first = next(p for row in program.shards for p in row if p is not None)
    route = (type(program).__name__, program.variant, program.chunk, program.layout,
             type(first).__name__, getattr(first, "by", None), getattr(first, "bx", None),
             program.transport_kind)
    routes = dist.all_gather_object(route)
    if any(r != route for r in routes):
        raise RuntimeError(f"the processes took different routes: {routes}")


def _tile(params: LBMParams, mesh: Mesh) -> tuple[int, int]:
    py, px = mesh.py, mesh.px
    ny, nx = params.ny, params.nx
    if AXIS_X in mesh.shape:
        if ny % py or nx % px:
            raise ValueError(f"grid {ny}x{nx} not divisible by mesh {py}x{px}")
    elif ny % py:
        raise ValueError(f"ny={ny} not divisible by mesh size {py}")
    return ny // py, nx // px


def _one_d(mesh: Mesh) -> Mesh:
    if AXIS_X in mesh.shape:
        raise ValueError("this factory takes a 1-D mesh; use its _2d counterpart")
    return mesh


def _two_d(mesh: Mesh) -> Mesh:
    if AXIS_X not in mesh.shape:
        raise ValueError("this factory takes a 2-D mesh; use its 1-D counterpart")
    return mesh


def _one_step(params, obstacles, free_cells_inv, mesh, max_iters, cls, variant):
    if max_iters is None:
        max_iters = params.max_iters
    layout = TileLayout(*_tile(params, mesh), 1)
    return ShardedProgram(
        params, obstacles, free_cells_inv, mesh, max_iters, layout,
        lambda fluid, row0, dev: cls(params, fluid, layout, row0, free_cells_inv, dev),
        variant)


def make_sharded_run(params, obstacles, free_cells_inv, mesh, max_iters=None):
    """Row-sharded run of the plain torch step per shard (any device)."""
    return _one_step(params, obstacles, free_cells_inv, _one_d(mesh), max_iters,
                     ShardProgram, "reference")


def make_sharded_2d_run(params, obstacles, free_cells_inv, mesh, max_iters=None):
    """2-D (rows x cols) run of the plain torch step per shard."""
    return _one_step(params, obstacles, free_cells_inv, _two_d(mesh), max_iters,
                     ShardProgram, "reference")


def make_sharded_fused_run(params, obstacles, free_cells_inv, mesh, max_iters=None):
    """Row-sharded run of the shard one-step kernel (``lbm_shard_step``)."""
    return _one_step(params, obstacles, free_cells_inv, _one_d(mesh), max_iters,
                     ShardStep, "fused")


def make_sharded_fused_2d_run(params, obstacles, free_cells_inv, mesh, max_iters=None):
    """2-D run of the shard one-step kernel: every tile padded in x and y
    (``lbm_tpu`` returns None where its padded tile has no row-block split;
    here every tile has one)."""
    return _one_step(params, obstacles, free_cells_inv, _two_d(mesh), max_iters,
                     ShardStep, "fused")


def _tile_width(width: int, by: int, ksteps: int) -> int:
    """The first tile width of the schedule's order
    (:data:`schedule.TEMPORAL_TILES`, then ``width`` itself) that divides
    ``width`` and whose windows fit a block's shared memory with (BY, K)
    (:func:`schedule.persistent_fits`: the temporal and x-tiled shard
    kernels are both persistent passes); ValueError where none does."""
    widths = [bx for _, bx in schedule.TEMPORAL_TILES] + [width]
    bx = next((w for w in widths
               if width % w == 0 and schedule.persistent_fits(by, w, ksteps)), None)
    if bx is None:
        raise ValueError(f"no tile width for BY={by}, K={ksteps} divides {width} "
                         "within a block's shared memory")
    return bx


def choose_shard_temporal(nyl: int, nxl: int, max_iters: int, by: int | None = None,
                          ksteps: int | None = None,
                          device_kind: str | None = None) -> tuple[int, int, int] | None:
    """``(by, bx, K)`` of the shard temporal kernel on an ``nyl x nxl``
    tile: :func:`schedule.choose_temporal` on the tile (the tuning cache of
    ``device_kind`` first), kept where ``K <= min(nyl, nxl)`` (the halo
    comes from one neighbour), else None.  An explicit ``(by, ksteps)`` is
    validated (ValueError where it is not valid) and takes the first tile
    width of the schedule's order that divides nxl and fits a block's
    shared memory."""
    if by is None or ksteps is None:
        picked = schedule.choose_temporal(nyl, nxl, max_iters, device_kind)
        if picked is None or picked[2] > min(nyl, nxl):
            return None
        return picked
    if by < 1 or nyl % by:
        raise ValueError(f"BY={by} does not divide local slab nyl={nyl}")
    if ksteps < 1 or max_iters % ksteps or ksteps > min(nyl, nxl):
        raise ValueError(f"need K | max_iters and 1 <= K <= min(nyl, nxl) (K={ksteps}, "
                         f"max_iters={max_iters}, tile {nyl}x{nxl})")
    return by, _tile_width(nxl, by, ksteps), ksteps


def _temporal(params, obstacles, free_cells_inv, mesh, max_iters, by, ksteps):
    if max_iters is None:
        max_iters = params.max_iters
    nyl, nxl = _tile(params, mesh)
    picked = choose_shard_temporal(nyl, nxl, max_iters, by, ksteps, _kind(mesh))
    if picked is None:
        return None
    by, bx, k = picked
    layout = TileLayout(nyl, nxl, k)
    return ShardedProgram(
        params, obstacles, free_cells_inv, mesh, max_iters, layout,
        lambda fluid, row0, dev: ShardTemporalStep(params, fluid, layout, row0,
                                                   free_cells_inv, dev, by, bx),
        "temporal")


def _pingpong_fits(mesh: Mesh, layout: TileLayout) -> bool:
    """Whether every device holds the padded ping-pong tiles (and masks)
    of the shards it carries within ``runtime.hbm_budget_gib``."""
    rows, stride = layout.rows, layout.stride
    per_shard = (2 * NSPEEDS * 4 + 1) * rows * stride
    on = collections.Counter(mesh.device(iy, ix) for iy, ix in mesh.local_positions())
    return all(n * per_shard <= runtime.hbm_budget_gib(d) * 2**30 for d, n in on.items())


def _kind(mesh: Mesh) -> str:
    """The tuning cache's name for the mesh's devices (this process's first
    shard's)."""
    return tuning.device_kind(mesh.local_devices()[0])


def _autotune_slab(params: LBMParams, mesh: Mesh, schedules: tuple[str, ...]) -> None:
    """Opt-in (``LBM_AUTOTUNE_ON_MISS=1``): measure the local slab shape
    before the chooser reads the cache, as ``lbm_tpu``'s sharded factories
    do; ``schedules`` are the ones the caller's route can take."""
    if params.ny % mesh.py or params.nx % mesh.px:
        return  # the factory raises lbm_tpu's error
    tuning.maybe_autotune_slab(params.ny // mesh.py, params.nx // mesh.px, _kind(mesh),
                               schedules=schedules)


def _auto_xt(params, obstacles, free_cells_inv, mesh, max_iters):
    """The sharded x-tiled program where the single-device rule takes the
    in-place kernel: ``lbm_tpu``'s gate admits the slab
    (:func:`schedule.choose_temporal_xtiled`, whose tile it takes) and the
    shards' ping-pong tiles do not fit their devices; else None."""
    if max_iters is None:
        max_iters = params.max_iters
    if params.ny % mesh.py:
        return None  # the temporal factory raises lbm_tpu's error
    nyl, nx = params.ny // mesh.py, params.nx
    picked = schedule.choose_temporal_xtiled(nyl, nx, max_iters, _kind(mesh))
    if picked is None or picked[2] > nyl or _pingpong_fits(
            mesh, TileLayout(nyl, nx, picked[2])):
        return None
    return _xt_program(params, obstacles, free_cells_inv, mesh, max_iters, *picked)


def make_sharded_temporal_run(params, obstacles, free_cells_inv, mesh, max_iters=None, *,
                              by=None, ksteps=None, px=None):
    """Row-sharded run of the shard temporal kernel: K steps per launch,
    one K-deep halo exchange per K steps.  None where the shard tile admits
    no split; an explicit ``(by, ksteps)`` that is not valid raises.
    ``lbm_tpu``'s routing: an explicit ``px > 1`` takes the x-tiled route
    (:func:`make_sharded_temporal_xt_run`); without ``(by, ksteps)`` the
    slab takes it where the single-device schedule would take the x-tiled
    kernel (``px`` is then not read, as in ``lbm_tpu``)."""
    mesh = _one_d(mesh)
    if by is None or ksteps is None:
        _autotune_slab(params, mesh, tuning.SCHEDULES)
        xt = _auto_xt(params, obstacles, free_cells_inv, mesh, max_iters)
        if xt is not None:
            return xt
    elif px is not None and px > 1:
        return make_sharded_temporal_xt_run(params, obstacles, free_cells_inv, mesh,
                                            max_iters, by=by, ksteps=ksteps, px=px)
    return _temporal(params, obstacles, free_cells_inv, mesh, max_iters, by, ksteps)


def make_sharded_temporal_2d_run(params, obstacles, free_cells_inv, mesh, max_iters=None,
                                 *, by=None, ksteps=None):
    """2-D run of the shard temporal kernel, K-deep halos in both axes.  On
    a mesh of one column without ``(by, ksteps)``, the slab takes the
    x-tiled route where the single-device schedule would (``lbm_tpu``'s
    degenerate-x branch)."""
    mesh = _two_d(mesh)
    if by is None or ksteps is None:
        # A mesh of one column can take the x-tiled route; a wider one
        # only the temporal kernel on its tile.
        _autotune_slab(params, mesh, tuning.SCHEDULES if mesh.px == 1 else ("temporal",))
    if mesh.px == 1 and (by is None or ksteps is None):
        xt = _auto_xt(params, obstacles, free_cells_inv, mesh, max_iters)
        if xt is not None:
            return xt
    return _temporal(params, obstacles, free_cells_inv, mesh, max_iters, by, ksteps)


def make_sharded_temporal_xt_run(params, obstacles, free_cells_inv, mesh, max_iters=None,
                                 *, by, ksteps, px):
    """Row-sharded run of the shard x-tiled kernel
    (``lbm_shard_temporal_xt_step``): each shard runs the in-place x-tiled
    pass on its row slab, K steps per launch, and only K ghost rows each
    way cross shards, before every pass (:class:`GhostExchange`).  x never
    crosses shards, so the mesh is 1-D or ``(Py, 1)``.

    ``by`` and ``ksteps`` are taken as given: BY | nyl, K | max_iters and
    K <= nyl (the ghost rows come from one neighbour); ``lbm_tpu``'s
    K <= BY-2 is not needed, since kicks go by global row.  ``px`` keeps
    ``lbm_tpu``'s meaning and checks (px >= 2, px | nx) and selects this
    route; on Hopper it does not set the tile, which is a block's window,
    not a strip: BX is the first width of the schedule's order
    (:data:`schedule.TEMPORAL_TILES`, then nx/px itself) that divides nx/px
    and whose windows fit a block's shared memory with (BY, K) in the
    persistent pass's footprint, as :func:`choose_shard_temporal` picks the
    temporal kernel's for an explicit (BY, K)."""
    if max_iters is None:
        max_iters = params.max_iters
    if AXIS_X in mesh.shape and mesh.px != 1:
        raise ValueError(
            "the x-tiled sharded schedule needs a 1-D mesh or a 2-D mesh "
            f"with one x shard (got {mesh.px} x shards); a wider x mesh "
            "already divides nx and keeps row blocking")
    ny, nx = params.ny, params.nx
    if ny % mesh.py:
        raise ValueError(f"ny={ny} not divisible by mesh size {mesh.py}")
    nyl = ny // mesh.py
    if ksteps < 1 or max_iters % ksteps:
        raise ValueError(f"need K | max_iters (K={ksteps}, max_iters={max_iters})")
    if nx % px:
        raise ValueError(f"px={px} does not divide nx={nx}")
    if px < 2:
        raise ValueError("x-tiling needs px >= 2 (use the 1-D temporal "
                         "program for a single strip)")
    if by < 1 or nyl % by:
        raise ValueError(f"BY={by} does not divide ny={nyl}")
    if ksteps > nyl:
        raise ValueError(f"need K <= nyl (K={ksteps}, nyl={nyl}): the ghost rows come "
                         "from one neighbour")
    return _xt_program(params, obstacles, free_cells_inv, mesh, max_iters, by,
                       _tile_width(nx // px, by, ksteps), ksteps)


def _xt_program(params, obstacles, free_cells_inv, mesh, max_iters, by, bx, ksteps):
    layout = SlabLayout(params.ny // mesh.py, params.nx, ksteps)
    return ShardedXtProgram(
        params, obstacles, free_cells_inv, mesh, max_iters, layout,
        lambda mask, row0, dev: ShardTemporalXtStep(params, mask, layout, row0,
                                                    free_cells_inv, dev, by, bx),
        "temporal")


@dataclasses.dataclass
class ShardedRunResult(diagnostics.ResultMetrics):
    params: LBMParams
    f: np.ndarray | ShardedState | None
    av_vels: np.ndarray
    obstacles: np.ndarray
    free_cells_inv: float
    elapsed: float
    n_shards: int
    fields: np.ndarray | None = None  # [4, ny, nx] when readback="fields"
    steps_timed: int | None = None
    steps_per_pass: int = 1
    bytes_per_update: float = float(schedule.BYTES_PER_CELL)


class ShardedSimulator:
    """A sharded simulation: grid, obstacles, mesh, kernel (the weak-scaling
    path of ``BASELINE.json`` ``configs[4]``, 4096x4096 sharded).

    ``kernel``: ``"fused"`` tries, on a 1-D mesh, the temporal kernel, then
    the one-step kernel; on a 2-D mesh the one-step kernel (the temporal
    kernel first when ``temporal_split`` is given).  ``temporal_split`` is
    ``(BY, K)`` or ``(BY, K, PX)``; the three-part form takes the x-tiled
    route (:func:`make_sharded_temporal_xt_run`; on a 2-D mesh only with
    one x shard), as does the temporal kernel without a split wherever the
    single-device schedule would take the x-tiled kernel.  ``"temporal"`` takes
    the temporal kernel only.  ``"reference"`` is the plain step on any
    device.  ``"auto"`` is ``"fused"`` on CUDA and ``"reference"`` on the
    CPU (``lbm_tpu.parallel.sharded.ShardedSimulator``'s order).  The
    temporal kernel is skipped where the tile admits no split; the
    one-step kernel admits every tile, so ``lbm_tpu``'s last resort of
    its chain, the plain step, is never reached and not in it.  A kernel
    that fails to build or launch raises: nothing gives way to the plain
    version on the card."""

    def __init__(self, params: LBMParams, obstacles: np.ndarray, mesh: Mesh | None = None,
                 kernel: str = "auto",
                 temporal_split: tuple[int, ...] | None = None) -> None:
        self.params = params
        self.obstacles = np.asarray(obstacles, dtype=bool)
        if self.obstacles.shape != (params.ny, params.nx):
            raise ValueError(f"obstacle mask {self.obstacles.shape} != grid "
                             f"{(params.ny, params.nx)}")
        self.mesh = mesh if mesh is not None else default_mesh()
        on_cuda = self.mesh.local_devices()[0].type == "cuda"
        if kernel == "auto":
            kernel = "fused" if on_cuda else "reference"
        if kernel not in ("fused", "temporal", "reference"):
            raise ValueError(f"unknown sharded kernel {kernel!r}; choose auto | fused | "
                             "temporal | reference (the 'mega' variant is single-chip "
                             "only)")
        if temporal_split is not None and kernel == "reference":
            raise ValueError(f"temporal_split={temporal_split} requires kernel='fused' "
                             "or 'temporal', not 'reference'")
        if temporal_split is not None and len(temporal_split) not in (2, 3):
            raise ValueError(f"temporal_split must be (BY, K) or (BY, K, PX), got "
                             f"{temporal_split!r}")
        self.kernel = kernel
        self.temporal_split = temporal_split
        self.free_cells = free_cells_of(self.obstacles)
        self.free_cells_inv = np.float32(1.0) / np.float32(self.free_cells)
        # Builds the CUDA kernels here, before any timer.
        if on_cuda and kernel != "reference":
            _build.load_library()
        self._programs: dict[int, ShardedProgram] = {}
        self._fields = raw_fields_fn(params)

    def _factories(self, max_iters: int) -> list[Callable[[], ShardedProgram | None]]:
        common = (self.params, self.obstacles, self.free_cells_inv, self.mesh, max_iters)
        split = self.temporal_split or (None, None)
        by, ksteps, px = split[0], split[1], (split[2] if len(split) > 2 else None)
        if AXIS_X in self.mesh.shape:
            if px is not None:  # straight to the x-tiled factory, which checks the mesh
                temporal = lambda: make_sharded_temporal_xt_run(  # noqa: E731
                    *common, by=by, ksteps=ksteps, px=px)
            else:
                temporal = lambda: make_sharded_temporal_2d_run(  # noqa: E731
                    *common, by=by, ksteps=ksteps)
            if self.kernel == "temporal":
                return [temporal]
            if self.kernel == "fused":
                fused_2d = lambda: make_sharded_fused_2d_run(*common)  # noqa: E731
                return [temporal, fused_2d] if self.temporal_split else [fused_2d]
            return [lambda: make_sharded_2d_run(*common)]
        temporal = lambda: make_sharded_temporal_run(  # noqa: E731
            *common, by=by, ksteps=ksteps, px=px)
        if self.kernel == "temporal":
            return [temporal]
        if self.kernel == "fused":
            return [temporal, lambda: make_sharded_fused_run(*common)]
        return [lambda: make_sharded_run(*common)]

    def compiled(self, max_iters: int | None = None) -> ShardedProgram:
        """The sharded program of a run of ``max_iters`` steps (made once
        per length, masks uploaded, outside any timer): the first variant
        of the routing chain that admits the run.  Over several processes
        every process must have taken the same route and transport, and
        each prints them once a program."""
        if max_iters is None:
            max_iters = self.params.max_iters
        if max_iters not in self._programs:
            _tile(self.params, self.mesh)  # the divisibility error, whatever the route
            program = None
            for make in self._factories(max_iters):
                program = make()
                if program is not None:
                    break
            if program is None:
                raise ValueError("no valid temporal (BY, K) split for this "
                                 "grid/mesh/max_iters")
            _same_route(program)
            if dist.process_count() > 1:
                print(f"process {dist.process_index()}: {max_iters} steps on the "
                      f"{program.variant} route (chunk {program.chunk}), pieces across "
                      f"processes over {program.transport_kind}", flush=True)
            self._programs[max_iters] = program
        return self._programs[max_iters]

    def chunk(self, max_iters: int | None = None) -> int:
        """Timesteps per kernel launch of the program that runs."""
        return self.compiled(max_iters).chunk

    def variant(self, max_iters: int | None = None) -> str:
        """Which variant the routing landed on: 'temporal', 'fused' or
        'reference'."""
        return self.compiled(max_iters).variant

    def _sync(self) -> None:
        for d in self.mesh.local_devices():
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def run(self, max_iters: int | None = None, readback: str = "state",
            f0=None) -> ShardedRunResult:
        """Initialise (or upload ``f0``: a host array, a tensor or a
        :class:`ShardedState`), run the time loop, read back once.

        The timed region is :meth:`ShardedProgram.run` (the buffers, from
        the allocator's cache after a first run, the upload and the loop)
        and the readback, as in ``Simulator.run``.  ``"state"`` gathers f
        on the host shard by shard; ``"fields"`` computes each shard's
        float16 ``[u_x, u_y, rho - density]`` on its device and fetches
        those (|u| and pressure derived on the host after the timer);
        ``"device"`` leaves f on the shards (:class:`ShardedState`) and
        fetches av only: over several processes, this process's shards and
        the whole av, on every process (``"state"`` and ``"fields"``
        raise there).  The timer starts when every process has reached it."""
        check_readback(readback)
        if readback != "device" and dist.process_count() > 1:
            raise ValueError(f"readback={readback!r} over {dist.process_count()} "
                             f"processes: {SINGLE_CONTROLLER}")
        if max_iters is None:
            max_iters = self.params.max_iters
        program = self.compiled(max_iters)
        lay = program.layout
        ny, nx = self.params.ny, self.params.nx
        self._sync()
        dist.barrier("ShardedSimulator.run")
        tic = time.perf_counter()
        with _guard(program.device0):
            state, av = program.run(f0)
            av = av.cpu().numpy()
            if readback == "state":
                out = state.cpu().numpy()
            elif readback == "fields":
                out = np.empty((3, ny, nx), np.float16)
                for (y0, x0, t), (_, _, prog) in zip(state.tiles, program.positions()):
                    raw = self._fields(t, lay.interior(prog.fluid).bool())
                    out[:, y0:y0 + lay.nyl, x0:x0 + lay.nxl] = raw.cpu().numpy()
            else:
                out = state
        toc = time.perf_counter()
        if readback == "fields":
            out = expand_fields(out, self.obstacles, self.params.density)
        return ShardedRunResult(
            params=dataclasses.replace(self.params, max_iters=max_iters),
            f=None if readback == "fields" else out,
            fields=out if readback == "fields" else None,
            av_vels=av,
            obstacles=self.obstacles,
            free_cells_inv=float(self.free_cells_inv),
            elapsed=toc - tic,
            n_shards=self.mesh.size,
            steps_timed=max_iters,
            steps_per_pass=program.chunk,
            bytes_per_update=program.bytes_per_update,
        )

    def run_checkpointed(self, checkpoint_dir: str, every: int,
                         max_iters: int | None = None,
                         resume: bool = True) -> ShardedRunResult:
        """Segmented sharded run with checkpoint/resume (the contract of
        ``Simulator.run_checkpointed``).  f stays on the shards between
        segments (``readback="device"``); each snapshot is per shard
        (:func:`lbm_tpu_torch.checkpoint.save_sharded`, no global gather on
        the device).  A resume reassembles the global f on the host and
        uploads it, so a run can resume on another mesh, or from a
        single-device or ``lbm_tpu`` snapshot."""
        if max_iters is None:
            max_iters = self.params.max_iters
        f, av, elapsed, executed = run_segments_checkpointed(
            run_segment=lambda seg, f0: self.run(max_iters=seg, f0=f0,
                                                 readback="device"),
            precompile=self.compiled,
            params=self.params,
            obstacles=self.obstacles,
            checkpoint_dir=checkpoint_dir,
            every=every,
            max_iters=max_iters,
            resume=resume,
            save_fn=ckpt.save_sharded,
        )
        if f is None:  # zero remaining work and nothing checkpointed
            return self.run(max_iters=0)
        if not isinstance(f, np.ndarray):
            # The snapshot committed just above holds exactly this state.
            f = ckpt.load(checkpoint_dir).f
        return ShardedRunResult(
            params=dataclasses.replace(self.params, max_iters=max_iters),
            f=np.asarray(f),
            av_vels=av,
            obstacles=self.obstacles,
            free_cells_inv=float(self.free_cells_inv),
            elapsed=elapsed,
            n_shards=self.mesh.size,
            steps_timed=executed,
            steps_per_pass=self.chunk(min(every, executed)) if executed else 1,
            bytes_per_update=(self.compiled(min(every, executed)).bytes_per_update
                              if executed else float(schedule.BYTES_PER_CELL)),
        )


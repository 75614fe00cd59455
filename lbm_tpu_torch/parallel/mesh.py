"""The device mesh of a sharded run: which device holds each shard.

The port of ``lbm_tpu.parallel.sharded``'s ``default_mesh`` /
``default_mesh_2d`` and ``_rings``.  Each mesh position belongs to one
process (:mod:`lbm_tpu_torch.parallel.dist`; one process without a group,
which then drives every shard, a single controller as ``lbm_tpu``'s
``shard_map`` over a ``Mesh`` is).  The default meshes span every process
in ``jax.devices()``' order, process-major: position i (row-major) belongs
to process ``i // (n // process_count())``.  Each shard has its own tensors
and kernel launches on its device; the halo exchange between two shards of
one process is a device-to-device copy, and between processes a message
over the group.  A process's shards map onto its visible CUDA devices
round-robin, so one card carries any mesh, as the 8 virtual CPU devices
carry ``lbm_tpu``'s test meshes.  ``LBM_DEVICE=cpu`` puts every shard on
the CPU (the plain torch path); an integer puts every shard on that CUDA
device.  Without CUDA, anything but ``cpu`` raises: there is no silent CPU
default.
"""

from __future__ import annotations

import collections
import os

import numpy as np
import torch

from lbm_tpu_torch.parallel import dist

AXIS, AXIS_X = "y", "x"


class Mesh:
    """Devices by mesh position: ``devices`` is an array of
    ``torch.device`` of shape ``[n]`` (a 1-D row mesh, axis ``"y"``) or
    ``[py, px]`` (rows x cols, axes ``"y"``, ``"x"``).  ``shape`` maps the
    axis names to their sizes, as ``jax.sharding.Mesh.shape`` does.
    ``procs`` (the same nesting, default: this process everywhere) names the
    process that owns each position; a position of another process has no
    device here (None)."""

    def __init__(self, devices, axis_names: tuple[str, ...], procs=None) -> None:
        def grid(x):
            return [list(x)] if len(axis_names) == 1 else [list(r) for r in x]

        rows = grid(devices)
        if (len(axis_names) not in (1, 2) or not rows or not rows[0]
                or any(len(r) != len(rows[0]) for r in rows)):
            raise ValueError(f"a mesh of axes {axis_names} needs a non-empty, "
                             f"rectangular {len(axis_names)}-D list of devices")
        me, count = dist.process_index(), dist.process_count()
        owners = (np.full((len(rows), len(rows[0])), me) if procs is None
                  else np.array(grid(procs), dtype=np.int64))
        if owners.shape != (len(rows), len(rows[0])):
            raise ValueError(f"procs {owners.shape} does not match the devices "
                             f"{(len(rows), len(rows[0]))}")
        if ((owners < 0) | (owners >= count)).any():
            raise ValueError(f"procs must lie in [0, {count}), got {sorted(set(owners.flat))}")
        arr = np.empty((len(rows), len(rows[0])), dtype=object)
        for iy, row in enumerate(rows):
            for ix, d in enumerate(row):
                if owners[iy, ix] == me:
                    if d is None:
                        raise ValueError(f"position {(iy, ix)} of this process has no device")
                    arr[iy, ix] = torch.device(d)
        one_d = len(axis_names) == 1
        self.devices = arr[0] if one_d else arr
        self.procs = owners[0] if one_d else owners
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def py(self) -> int:
        return self.devices.shape[0]

    @property
    def px(self) -> int:
        return self.devices.shape[1] if self.devices.ndim == 2 else 1

    @property
    def size(self) -> int:
        return self.devices.size

    def _at(self, arr, iy: int, ix: int):
        return arr[iy, ix] if arr.ndim == 2 else arr[iy]

    def device(self, iy: int, ix: int = 0) -> torch.device | None:
        """The device of a position (None where another process owns it)."""
        return self._at(self.devices, iy, ix)

    def owner(self, iy: int, ix: int = 0) -> int:
        """The process that owns a position."""
        return int(self._at(self.procs, iy, ix))

    def positions_of(self, proc: int) -> list[tuple[int, int]]:
        """The ``(iy, ix)`` positions ``proc`` owns, in mesh (row-major)
        order."""
        return [(iy, ix) for iy in range(self.py) for ix in range(self.px)
                if self.owner(iy, ix) == proc]

    def local_positions(self) -> list[tuple[int, int]]:
        """This process's positions, in mesh order."""
        return self.positions_of(dist.process_index())

    def local_devices(self) -> list[torch.device]:
        """This process's devices, each once, in mesh order."""
        return list(dict.fromkeys(self.device(iy, ix) for iy, ix in self.local_positions()))

    @property
    def processes(self) -> list[int]:
        return sorted({int(p) for p in self.procs.flat})

    def describe(self) -> str:
        """``"2x2 (rows x cols), 4 shard(s): cuda:0 x4"``: the shape and where
        the shards sit; a mesh over several processes names each process
        and, for this one, its devices."""
        kind = (f"{self.py}x{self.px} (rows x cols)" if self.devices.ndim == 2
                else f"{self.py} row shard(s)")
        me = dist.process_index()

        def sits(proc):
            where = collections.Counter(str(self.device(iy, ix))
                                        for iy, ix in self.positions_of(proc))
            return ", ".join(f"{d} x{n}" for d, n in where.items())

        if self.processes == [me]:
            return f"{kind}, {self.size} shard(s): {sits(me)}"
        return (f"{kind}, {self.size} shard(s) over {len(self.processes)} processes: "
                + "; ".join(f"process {p} (this one): {sits(p)}" if p == me
                            else f"process {p}: {len(self.positions_of(p))} shard(s)"
                            for p in self.processes))


def visible_devices() -> list[torch.device]:
    """The devices shards go to, from ``LBM_DEVICE``: ``cpu``; one CUDA
    index; or, unset, every visible CUDA device.  Raises without CUDA
    unless ``cpu`` (:func:`lbm_tpu_torch.runtime.select_device`)."""
    # Imported here: the runtime imports the step programs, which import
    # this package's tile layout.
    from lbm_tpu_torch.runtime import select_device

    spec = os.environ.get("LBM_DEVICE", "").strip()
    if spec:
        return [select_device(spec)]
    select_device(None)  # raises without CUDA
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _place(n: int) -> tuple[list[torch.device | None], list[int]]:
    """``(devices, procs)`` of n positions spread over every process,
    process-major: position i belongs to process ``i // (n // count)``,
    whose own positions go round-robin over its visible devices (another
    process's positions have no device here)."""
    count, me = dist.process_count(), dist.process_index()
    if n % count:
        raise ValueError(f"a mesh of {n} shards does not divide over {count} processes")
    local = n // count
    devs = visible_devices()
    procs = [i // local for i in range(n)]
    return ([devs[(i - p * local) % len(devs)] if p == me else None
             for i, p in enumerate(procs)], procs)


def default_mesh(n_devices: int | None = None) -> Mesh:
    """1-D row mesh of ``n_devices`` shards (default: one per visible
    device of every process), spanning every process, each process's
    round-robin over its visible devices."""
    n = len(visible_devices()) * dist.process_count() if n_devices is None else n_devices
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    devices, procs = _place(n)
    return Mesh(devices, (AXIS,), procs)


def default_mesh_2d(py: int, px: int) -> Mesh:
    """2-D mesh (rows x cols) of ``py * px`` shards in row-major order,
    spanning every process as :func:`default_mesh` does."""
    if py < 1 or px < 1:
        raise ValueError(f"a mesh needs positive sizes, got {py}x{px}")
    flat, procs = _place(py * px)
    return Mesh([flat[i * px:(i + 1) * px] for i in range(py)], (AXIS, AXIS_X),
                [procs[i * px:(i + 1) * px] for i in range(py)])


def _rings(n: int) -> tuple[list[tuple[int, int]], list[tuple[int, int]]]:
    """(down, up) neighbour pairs ``(src, dst)`` of a ring over an n-shard
    mesh axis (``lbm_tpu``'s ``_rings``): down sends shard i's last rows
    (columns) to shard i+1, up its first to shard i-1."""
    down = [(i, (i + 1) % n) for i in range(n)]
    up = [(i, (i - 1) % n) for i in range(n)]
    return down, up

"""The device mesh of a sharded run: which device holds each shard.

The port of ``lbm_tpu.parallel.sharded``'s ``default_mesh`` /
``default_mesh_2d`` and ``_rings``.  One process drives every shard (a
single controller, as ``lbm_tpu``'s ``shard_map`` over a ``Mesh`` is): each
shard has its own tensors and kernel launches on its device, and the halo
exchange between shards is a device-to-device copy.  Shards map onto the
visible CUDA devices round-robin, so one card carries any mesh, as the 8
virtual CPU devices carry ``lbm_tpu``'s test meshes.  ``LBM_DEVICE=cpu``
puts every shard on the CPU (the plain torch path); an integer puts every
shard on that CUDA device.  Without CUDA, anything but ``cpu`` raises:
there is no silent CPU default.
"""

from __future__ import annotations

import collections
import os

import numpy as np
import torch

AXIS, AXIS_X = "y", "x"


class Mesh:
    """Devices by mesh position: ``devices`` is an array of
    ``torch.device`` of shape ``[n]`` (a 1-D row mesh, axis ``"y"``) or
    ``[py, px]`` (rows x cols, axes ``"y"``, ``"x"``).  ``shape`` maps the
    axis names to their sizes, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices, axis_names: tuple[str, ...]) -> None:
        rows = [list(devices)] if len(axis_names) == 1 else [list(r) for r in devices]
        if (len(axis_names) not in (1, 2) or not rows or not rows[0]
                or any(len(r) != len(rows[0]) for r in rows)):
            raise ValueError(f"a mesh of axes {axis_names} needs a non-empty, "
                             f"rectangular {len(axis_names)}-D list of devices")
        arr = np.empty((len(rows), len(rows[0])), dtype=object)
        for iy, row in enumerate(rows):
            for ix, d in enumerate(row):
                arr[iy, ix] = torch.device(d)
        self.devices = arr[0] if len(axis_names) == 1 else arr
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

    def device(self, iy: int, ix: int = 0) -> torch.device:
        return self.devices[iy, ix] if self.devices.ndim == 2 else self.devices[iy]

    def describe(self) -> str:
        """``"2x2 (rows x cols), 4 shards: cuda:0 x4"``: the shape and where
        the shards sit."""
        kind = (f"{self.py}x{self.px} (rows x cols)" if self.devices.ndim == 2
                else f"{self.py} row shard(s)")
        sits = collections.Counter(str(d) for d in self.devices.flat)
        return (f"{kind}, {self.size} shard(s): "
                + ", ".join(f"{d} x{n}" for d, n in sits.items()))


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


def _place(n: int) -> list[torch.device]:
    devs = visible_devices()
    return [devs[i % len(devs)] for i in range(n)]


def default_mesh(n_devices: int | None = None) -> Mesh:
    """1-D row mesh of ``n_devices`` shards (default: one per visible
    device), round-robin over the visible devices."""
    n = len(visible_devices()) if n_devices is None else n_devices
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    return Mesh(_place(n), (AXIS,))


def default_mesh_2d(py: int, px: int) -> Mesh:
    """2-D mesh (rows x cols) of ``py * px`` shards, round-robin over the
    visible devices in row-major order."""
    if py < 1 or px < 1:
        raise ValueError(f"a mesh needs positive sizes, got {py}x{px}")
    flat = _place(py * px)
    return Mesh([flat[i * px:(i + 1) * px] for i in range(py)], (AXIS, AXIS_X))


def _rings(n: int) -> tuple[list[tuple[int, int]], list[tuple[int, int]]]:
    """(down, up) neighbour pairs ``(src, dst)`` of a ring over an n-shard
    mesh axis (``lbm_tpu``'s ``_rings``): down sends shard i's last rows
    (columns) to shard i+1, up its first to shard i-1."""
    down = [(i, (i + 1) % n) for i in range(n)]
    up = [(i, (i - 1) % n) for i in range(n)]
    return down, up

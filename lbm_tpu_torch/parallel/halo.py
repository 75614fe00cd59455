"""Halo-padded shard tiles and the two-phase exchange between them.

Shard (iy, ix) of a py x px mesh owns the nyl x nxl cells from global row
``iy * nyl`` and column ``ix * nxl``.  It keeps f in buffers
``[9, nyl + 2h, stride]`` (:class:`TileLayout`): h halo rows above and
below, the owned columns from ``lpad`` (a whole number of 32 floats, so
every owned row starts on a 128-byte boundary), h halo columns on each side
of them, and ``stride`` a multiple of 32 floats.  h is 1 for the one-step
kernel and K for the temporal kernel.  The uint8 mask is padded the same
way once, on the host, from the global mask with periodic wrap
(:func:`pad_mask`), so a halo cell collides and kicks as its owner does.

Before each launch, :class:`HaloExchange` fills the halo of the buffer the
launch reads, in ``lbm_tpu``'s two phases (``sharded.py:140-145``,
``610-636``): first h owned rows from each y-neighbour, then h columns
over all padded rows from each x-neighbour, so the corners ride along.  A
mesh axis of size 1 wraps onto the shard itself.  Each piece is one
``Tensor.copy_``: a local copy when both shards sit on one device, a peer
copy across devices.  (``lbm_tpu`` does this with ``ppermute`` and
``concatenate`` outside Pallas, so no kernel is replaced.)

The sharded x-tiled route keeps each shard's rows unpadded instead
(:class:`SlabLayout`: f ``[9, nyl, nx]``, x never split): its kernel
updates f in place and reads the K rows beyond the slab from a separate
ghost buffer ``[9, 2K, nx]``, which :class:`GhostExchange` fills before each
pass with two copies per shard, the y ring of ``_rings`` (``lbm_tpu``'s
``make_sharded_temporal_xt_run``, ``sharded.py:1115-1126``, patches the
same rows into its ghost slabs).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lbm_tpu_torch.ops.lattice import NSPEEDS
from lbm_tpu_torch.parallel.mesh import _rings

LANE = 32  # floats in 128 bytes


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class TileLayout:
    """The padded buffer of an ``nyl x nxl`` shard with an ``halo``-cell
    halo."""

    nyl: int
    nxl: int
    halo: int

    def __post_init__(self) -> None:
        if not 1 <= self.halo <= min(self.nyl, self.nxl):
            raise ValueError(f"a {self.halo}-cell halo needs a tile of at least "
                             f"{self.halo}x{self.halo}, got {self.nyl}x{self.nxl}")

    @property
    def lpad(self) -> int:
        """Column of owned column 0."""
        return _round_up(self.halo, LANE)

    @property
    def stride(self) -> int:
        return _round_up(self.lpad + self.nxl + self.halo, LANE)

    @property
    def rows(self) -> int:
        return self.nyl + 2 * self.halo

    @property
    def shape(self) -> tuple[int, int, int]:
        return (NSPEEDS, self.rows, self.stride)

    @property
    def buffer_shapes(self) -> tuple[tuple[int, int, int], ...]:
        """The buffers a shard's run binds: the ping-pong pair."""
        return (self.shape, self.shape)

    def pad_mask(self, fluid: np.ndarray, y0: int, x0: int) -> np.ndarray:
        return pad_mask(fluid, self, y0, x0)

    def interior(self, buf: torch.Tensor) -> torch.Tensor:
        """The owned cells of a padded buffer (or mask), a view."""
        h = self.halo
        return buf[..., h:h + self.nyl, self.lpad:self.lpad + self.nxl]

    def ext(self, buf: torch.Tensor) -> torch.Tensor:
        """The owned cells with their halo, ``[..., nyl + 2h, nxl + 2h]``,
        a view."""
        return buf[..., :, self.lpad - self.halo:self.lpad + self.nxl + self.halo]

    def halo_bytes(self) -> int:
        """f bytes one exchange copies into a tile: h rows of the owned
        width, then h columns of the padded height, on each side."""
        h = self.halo
        return 2 * h * (self.nxl + self.rows) * NSPEEDS * 4


def pad_mask(fluid: np.ndarray, layout: TileLayout, y0: int, x0: int) -> np.ndarray:
    """The uint8 mask (1 = fluid) of the tile at global (y0, x0), padded as
    its f buffers, the halo from the neighbours' cells with periodic wrap;
    columns outside the halo are 0."""
    ny, nx = fluid.shape
    h = layout.halo
    rows = (y0 - h + np.arange(layout.rows)) % ny
    cols = (x0 - h + np.arange(layout.nxl + 2 * h)) % nx
    out = np.zeros((layout.rows, layout.stride), np.uint8)
    out[:, layout.lpad - h:layout.lpad + layout.nxl + h] = fluid[rows[:, None], cols]
    return out


class HaloExchange:
    """Fills the halo of every tile of ``tiles`` (``[py][px]`` padded
    buffers of ``layout``) from its neighbours, y phase first; calling it
    issues the copies on the current streams."""

    def __init__(self, tiles: list[list[torch.Tensor]], layout: TileLayout) -> None:
        h, nyl, nxl, lp = layout.halo, layout.nyl, layout.nxl, layout.lpad
        py, px = len(tiles), len(tiles[0])
        own_cols = slice(lp, lp + nxl)
        self.pairs = []  # (destination view, source view), in order
        down, up = _rings(py)
        for ix in range(px):
            for src, dst in down:  # rows below a tile: its south neighbour's last h
                self.pairs.append((tiles[dst][ix][:, 0:h, own_cols],
                                   tiles[src][ix][:, nyl:nyl + h, own_cols]))
            for src, dst in up:  # rows above: its north neighbour's first h
                self.pairs.append((tiles[dst][ix][:, h + nyl:2 * h + nyl, own_cols],
                                   tiles[src][ix][:, h:2 * h, own_cols]))
        down, up = _rings(px)
        for iy in range(py):
            for src, dst in down:  # columns west of a tile, all padded rows
                self.pairs.append((tiles[iy][dst][:, :, lp - h:lp],
                                   tiles[iy][src][:, :, lp + nxl - h:lp + nxl]))
            for src, dst in up:  # columns east
                self.pairs.append((tiles[iy][dst][:, :, lp + nxl:lp + nxl + h],
                                   tiles[iy][src][:, :, lp:lp + h]))

    def __call__(self) -> None:
        for dst, src in self.pairs:
            dst.copy_(src)


@dataclasses.dataclass(frozen=True)
class SlabLayout:
    """The row slab of an ``nyl x nxl`` shard of the sharded x-tiled route
    (``nxl`` is the grid's width): f unpadded, ``[9, nyl, nxl]``, and a
    ghost buffer ``[9, 2 * halo, nxl]`` of the rows below and above it."""

    nyl: int
    nxl: int
    halo: int

    def __post_init__(self) -> None:
        if not 1 <= self.halo <= self.nyl:
            raise ValueError(f"{self.halo} ghost rows need a slab of at least "
                             f"{self.halo} rows, got {self.nyl}")

    @property
    def shape(self) -> tuple[int, int, int]:
        return (NSPEEDS, self.nyl, self.nxl)

    @property
    def ghost_shape(self) -> tuple[int, int, int]:
        return (NSPEEDS, 2 * self.halo, self.nxl)

    @property
    def buffer_shapes(self) -> tuple[tuple[int, int, int], ...]:
        """The buffers a shard's run binds: f, then the ghost rows."""
        return (self.shape, self.ghost_shape)

    def interior(self, buf: torch.Tensor) -> torch.Tensor:
        """The owned cells: the whole slab."""
        return buf

    def halo_bytes(self) -> int:
        """f bytes one exchange copies into a slab's ghost rows."""
        return 2 * self.halo * self.nxl * NSPEEDS * 4

    def pad_mask(self, fluid: np.ndarray, y0: int, x0: int) -> np.ndarray:
        """The uint8 mask (1 = fluid) of the slab from global row y0,
        padded by ``halo`` rows of the neighbours' mask with periodic wrap,
        as :func:`pad_mask` pads rows: ``[nyl + 2 * halo, nxl]``."""
        ny = fluid.shape[0]
        rows = (y0 - self.halo + np.arange(self.nyl + 2 * self.halo)) % ny
        return np.ascontiguousarray(fluid[rows, x0:x0 + self.nxl], dtype=np.uint8)


class GhostExchange:
    """Fills the ghost rows of every slab of ``slabs`` (``(f, ghost)`` in
    mesh order along y) from its neighbours' f: ghost rows ``[0, K)`` are
    the south neighbour's last K rows, ``[K, 2K)`` the north neighbour's
    first K (one shard: its own opposite edges).  Two ``Tensor.copy_`` per
    slab; calling it issues them on the current streams."""

    def __init__(self, slabs: list[tuple[torch.Tensor, torch.Tensor]],
                 layout: SlabLayout) -> None:
        k, nyl = layout.halo, layout.nyl
        down, up = _rings(len(slabs))
        self.pairs = []  # (destination view, source view), in order
        for src, dst in down:
            self.pairs.append((slabs[dst][1][:, :k], slabs[src][0][:, nyl - k:]))
        for src, dst in up:
            self.pairs.append((slabs[dst][1][:, k:], slabs[src][0][:, :k]))

    def __call__(self) -> None:
        for dst, src in self.pairs:
            dst.copy_(src)

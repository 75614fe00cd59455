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
mesh axis of size 1 wraps onto the shard itself.  (``lbm_tpu`` does this
with ``ppermute`` and ``concatenate`` outside Pallas, so no kernel is
replaced.)

Each exchange is one global, ordered list of pieces (:class:`Piece`: the
destination's position and slice, the source's, the phase), which each
process splits (:class:`SplitExchange`): a piece between two of its own
shards is one ``Tensor.copy_`` (a local copy on one device, a peer copy
across devices); a piece from one of its shards to another process's is a
send, and a piece into one of its shards from another process a receive,
both carried by a transport.  Over gloo (:class:`GroupTransport`, CPU
shards or processes on several hosts) a send is the source view packed
into a contiguous host buffer (pinned for a CUDA shard, after the shard's
stream has finished the launch that wrote it), then ``isend``; a receive
is ``irecv`` into a host buffer, then unpacked into the destination view
on the shard's stream, before its next launch.  Between processes of one
host with CUDA shards, :class:`lbm_tpu_torch.parallel.ipc.DeviceTransport`
packs a phase's pieces for a peer into that peer's device memory and
orders the copies with inter-process events, with no host copy and no
host synchronisation.  A piece's tag is its index in the global list.  In
each phase every receive is posted before the sends, and the x phase
starts only after every y-phase receive has landed (on the device
transport: is unpacked on the stream the x phase packs on), because its
columns carry the rows the y phase brought.  With one process every piece
is a local copy, in the list's order.

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
from typing import Callable

import numpy as np
import torch

from lbm_tpu_torch.ops.lattice import NSPEEDS
from lbm_tpu_torch.parallel import dist
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


@dataclasses.dataclass(frozen=True)
class Piece:
    """One piece of an exchange: buffer ``dst_buf`` of the shard at mesh
    position ``dst`` (``(iy, ix)``), at ``dst_index``, from buffer
    ``src_buf`` of the shard at ``src``, at ``src_index``, in ``phase``
    (0 the y phase, 1 the x phase)."""

    dst: tuple[int, int]
    dst_buf: int
    dst_index: tuple[slice, ...]
    src: tuple[int, int]
    src_buf: int
    src_index: tuple[slice, ...]
    phase: int


def halo_pieces(py: int, px: int, layout: TileLayout) -> list[Piece]:
    """The pieces that fill the halo of every tile of a py x px mesh, in
    order: the y phase (the rows below each tile, its south neighbour's
    last h owned rows, then the rows above), then the x phase (the columns
    west, then east, over all padded rows)."""
    h, nyl, nxl, lp = layout.halo, layout.nyl, layout.nxl, layout.lpad
    own_cols, every = slice(lp, lp + nxl), slice(None)
    out = []

    def piece(dst, dst_idx, src, src_idx, phase):
        out.append(Piece(dst, 0, (every, *dst_idx), src, 0, (every, *src_idx), phase))

    down, up = _rings(py)
    for ix in range(px):
        for src, dst in down:  # rows below a tile: its south neighbour's last h
            piece((dst, ix), (slice(0, h), own_cols), (src, ix),
                  (slice(nyl, nyl + h), own_cols), 0)
        for src, dst in up:  # rows above: its north neighbour's first h
            piece((dst, ix), (slice(h + nyl, 2 * h + nyl), own_cols), (src, ix),
                  (slice(h, 2 * h), own_cols), 0)
    down, up = _rings(px)
    for iy in range(py):
        for src, dst in down:  # columns west of a tile, all padded rows
            piece((iy, dst), (every, slice(lp - h, lp)), (iy, src),
                  (every, slice(lp + nxl - h, lp + nxl)), 1)
        for src, dst in up:  # columns east
            piece((iy, dst), (every, slice(lp + nxl, lp + nxl + h)), (iy, src),
                  (every, slice(lp, lp + h)), 1)
    return out


class GroupTransport:
    """Point-to-point messages over the process group (gloo: host
    tensors).  A wire: :class:`SplitExchange` stages each message through a
    host buffer for it (:class:`StagedLink`)."""

    def irecv(self, buf: torch.Tensor, peer: int, tag: int):
        return torch.distributed.irecv(buf, src=peer, tag=tag)

    def isend(self, buf: torch.Tensor, peer: int, tag: int):
        return torch.distributed.isend(buf, dst=peer, tag=tag)


@dataclasses.dataclass
class _Message:
    """A send (``view`` the source) or a receive (``view`` the
    destination) of one piece; ``host`` is its staging buffer on a wire
    (:class:`StagedLink`), None on the device transport."""

    tag: int
    peer: int
    view: torch.Tensor
    host: torch.Tensor | None = None


@dataclasses.dataclass
class _Phase:
    copies: list  # (destination view, source view), in order
    sends: list  # of _Message
    recvs: list  # of _Message
    number: int = 0  # the pieces' phase


def _host_buffer(view: torch.Tensor) -> torch.Tensor:
    return torch.empty(view.shape, dtype=view.dtype, pin_memory=view.device.type == "cuda")


def _cuda_devices(views) -> list[torch.device]:
    return list(dict.fromkeys(v.device for v in views if v.device.type == "cuda"))


class StagedLink:
    """An exchange's messages over a wire (``isend``/``irecv`` of host
    tensors: :class:`GroupTransport`, gloo), each staged through a host
    buffer of its own (pinned for a CUDA shard).

    A send packs its source view into its host buffer on the shard's
    current stream, synchronises that stream (the launch that wrote the
    rows, and the pack, are done), then sends.  A receive's host buffer is
    unpacked into its view on the shard's current stream, and an event
    after the unpacks keeps the next receive into the buffer from landing
    before they are done."""

    def __init__(self, wire, phases: list[_Phase]) -> None:
        self.wire, self.phases = wire, phases
        for ph in phases:
            for m in ph.sends + ph.recvs:
                m.host = _host_buffer(m.view)
        self._works: list[tuple[list, list]] = [([], []) for _ in phases]
        self._unpacked: list[list] = [[] for _ in phases]

    def start(self, i: int) -> None:
        """Phase ``i``: post its receives, pack and post its sends."""
        ph = self.phases[i]
        for ev in self._unpacked[i]:
            ev.synchronize()
        recvs = [self.wire.irecv(m.host, m.peer, m.tag) for m in ph.recvs]
        for m in ph.sends:
            m.host.copy_(m.view, non_blocking=True)
        for dev in _cuda_devices(m.view for m in ph.sends):
            torch.cuda.current_stream(dev).synchronize()
        sends = [self.wire.isend(m.host, m.peer, m.tag) for m in ph.sends]
        self._works[i] = (recvs, sends)

    def finish(self, i: int) -> None:
        """Phase ``i``: wait for its receives and unpack them, wait for its
        sends."""
        ph = self.phases[i]
        recvs, sends = self._works[i]
        for m, work in zip(ph.recvs, recvs):
            work.wait()
            m.view.copy_(m.host, non_blocking=True)
        events = []
        for dev in _cuda_devices(m.view for m in ph.recvs):
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events.append(ev)
        self._unpacked[i] = events
        for work in sends:
            work.wait()
        self._works[i] = ([], [])


class SplitExchange:
    """This process's part of an exchange: the global list ``pieces``
    split by the owners of their positions (``owner(pos)``; every piece is
    this process's where ``owner`` is None) into local copies, sends and
    receives, phase by phase.  ``bufs(pos)`` is the tuple of buffers of
    this process's shard at ``pos``.  Calling it runs every phase;
    :meth:`start` and :meth:`finish` run one (a loopback test interleaves
    several processes' exchanges through them).

    ``transport`` carries the sends and receives: a wire (``isend`` and
    ``irecv`` of host tensors, :class:`GroupTransport` by default), whose
    messages are staged through host buffers (:class:`StagedLink`), or a
    transport with a ``link(phases)`` of its own, such as
    :class:`lbm_tpu_torch.parallel.ipc.DeviceTransport`, card to card.  A
    transport that is given is linked even where no piece of this process
    crosses (its setup may be a collective)."""

    def __init__(self, pieces: list[Piece], bufs: Callable[[tuple[int, int]], tuple],
                 owner: Callable[[tuple[int, int]], int] | None = None,
                 rank: int | None = None, transport=None) -> None:
        rank = dist.process_index() if rank is None else rank
        numbers = sorted({p.phase for p in pieces})
        by_phase = {n: _Phase([], [], [], n) for n in numbers}
        for tag, p in enumerate(pieces):
            d_own = rank if owner is None else owner(p.dst)
            s_own = rank if owner is None else owner(p.src)
            ph = by_phase[p.phase]
            if d_own == rank and s_own == rank:
                ph.copies.append((bufs(p.dst)[p.dst_buf][p.dst_index],
                                  bufs(p.src)[p.src_buf][p.src_index]))
            elif s_own == rank:
                ph.sends.append(_Message(tag, d_own, bufs(p.src)[p.src_buf][p.src_index]))
            elif d_own == rank:
                ph.recvs.append(_Message(tag, s_own, bufs(p.dst)[p.dst_buf][p.dst_index]))
        self.phases: list[_Phase] = [by_phase[n] for n in numbers]
        # Today's single-process exchange: every piece a copy, in order.
        self.pairs = [c for ph in self.phases for c in ph.copies]
        self.remote = any(ph.sends or ph.recvs for ph in self.phases)
        if self.remote and transport is None:
            if not dist.initialized():
                raise RuntimeError("pieces of this exchange cross processes, but this "
                                   "process is in no process group (dist.initialize)")
            transport = GroupTransport()
        self.transport = transport
        self.link = None
        if transport is not None:
            self.link = (transport.link(self.phases) if hasattr(transport, "link")
                         else StagedLink(transport, self.phases))

    def start(self, i: int) -> None:
        """Phase ``i``: the transport's part (its receives posted, its
        sends packed and posted), then its local copies."""
        if self.link is not None:
            self.link.start(i)
        for dst, src in self.phases[i].copies:
            dst.copy_(src)

    def finish(self, i: int) -> None:
        """Phase ``i``: the transport's receives waited on and unpacked,
        its sends waited on."""
        if self.link is not None:
            self.link.finish(i)

    def __call__(self) -> None:
        if not self.remote:
            for dst, src in self.pairs:
                dst.copy_(src)
            return
        for i in range(len(self.phases)):
            self.start(i)
            self.finish(i)


class HaloExchange(SplitExchange):
    """Fills the halo of every tile of ``tiles`` (``[py][px]`` padded
    buffers of ``layout``; None where another process owns the position)
    from its neighbours, y phase first (:func:`halo_pieces`); ``procs``
    (``[py][px]``, a mesh's :attr:`~lbm_tpu_torch.parallel.mesh.Mesh.procs`)
    names the owners, default this process everywhere.  Calling it runs
    the copies on the current streams and trades the pieces that cross
    processes."""

    def __init__(self, tiles: list[list[torch.Tensor | None]], layout: TileLayout,
                 procs=None, rank: int | None = None, transport=None) -> None:
        owners = None if procs is None else np.asarray(procs).reshape(len(tiles), -1)
        super().__init__(halo_pieces(len(tiles), len(tiles[0]), layout),
                         lambda pos: (tiles[pos[0]][pos[1]],),
                         None if owners is None else lambda pos: int(owners[pos]),
                         rank, transport)


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


def ghost_pieces(py: int, layout: SlabLayout) -> list[Piece]:
    """The pieces that fill the ghost rows of every slab of a py-row mesh,
    in order: rows ``[0, K)`` of each ghost buffer (buffer 1) from its south
    neighbour's last K rows of f (buffer 0), then rows ``[K, 2K)`` from its
    north neighbour's first K."""
    k, nyl, every = layout.halo, layout.nyl, slice(None)
    down, up = _rings(py)
    return ([Piece((dst, 0), 1, (every, slice(0, k)), (src, 0), 0,
                   (every, slice(nyl - k, nyl)), 0) for src, dst in down]
            + [Piece((dst, 0), 1, (every, slice(k, 2 * k)), (src, 0), 0,
                     (every, slice(0, k)), 0) for src, dst in up])


class GhostExchange(SplitExchange):
    """Fills the ghost rows of every slab of ``slabs`` (``(f, ghost)`` in
    mesh order along y; None where another process owns the row) from its
    neighbours' f: ghost rows ``[0, K)`` are the south neighbour's last K
    rows, ``[K, 2K)`` the north neighbour's first K (one shard: its own
    opposite edges).  Two pieces per slab (:func:`ghost_pieces`), split by
    ``procs`` (the owner of each row, default this process) as
    :class:`HaloExchange` splits its pieces."""

    def __init__(self, slabs: list[tuple[torch.Tensor, torch.Tensor] | None],
                 layout: SlabLayout, procs=None, rank: int | None = None,
                 transport=None) -> None:
        owners = None if procs is None else np.asarray(procs).reshape(-1)
        super().__init__(ghost_pieces(len(slabs), layout), lambda pos: slabs[pos[0]],
                         None if owners is None else lambda pos: int(owners[pos[0]]),
                         rank, transport)

"""The halo and ghost exchanges split across processes, in one process.

Every exchange is one global, ordered list of pieces; each process keeps
the pieces between its own shards as local copies and turns the others
into sends and receives (``lbm_tpu_torch/parallel/halo.py``).  Here the
split is checked for every mesh of ``tests/test_torch_sharded.py`` over 1,
2 and 4 processes: the pieces match one to one, one process makes
exactly the copies the single-controller exchange made, and a loopback
transport, which carries the packed host buffers through a dict, fills
every halo and ghost row bitwise as the one-process exchange does.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lbm_tpu_torch import checkpoint as ckpt
from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.geometry import channel_box
from lbm_tpu_torch.parallel import dist, sharded
from lbm_tpu_torch.parallel import mesh as mesh_mod
from lbm_tpu_torch.parallel.halo import (
    GhostExchange,
    HaloExchange,
    SlabLayout,
    TileLayout,
    ghost_pieces,
    halo_pieces,
)
from lbm_tpu_torch.parallel.mesh import _rings

MESHES = [(1, None), (2, None), (8, None), (2, 4), (4, 2), (1, 4), (8, 1)]
SPLITS = [(m, p) for m in MESHES for p in (1, 2, 4) if (m[0] * (m[1] or 1)) % p == 0]
NYL, NXL = 6, 5


def _shape(mesh):
    py, px = mesh
    return py, px or 1


def _procs(py, px, n_procs):
    """Process-major owners, as default_mesh places them."""
    local = py * px // n_procs
    return np.arange(py * px).reshape(py, px) // local


def _split_id(case):
    (py, px), p = case
    return f"{py}x{px}-p{p}" if px else f"{py}-p{p}"


def _old_pairs(tiles, layout):
    """The single-controller exchange's copies, as it built them before
    the split: (destination view, source view), in order."""
    h, nyl, nxl, lp = layout.halo, layout.nyl, layout.nxl, layout.lpad
    py, px = len(tiles), len(tiles[0])
    own_cols = slice(lp, lp + nxl)
    pairs = []
    down, up = _rings(py)
    for ix in range(px):
        for src, dst in down:
            pairs.append((tiles[dst][ix][:, 0:h, own_cols],
                          tiles[src][ix][:, nyl:nyl + h, own_cols]))
        for src, dst in up:
            pairs.append((tiles[dst][ix][:, h + nyl:2 * h + nyl, own_cols],
                          tiles[src][ix][:, h:2 * h, own_cols]))
    down, up = _rings(px)
    for iy in range(py):
        for src, dst in down:
            pairs.append((tiles[iy][dst][:, :, lp - h:lp],
                          tiles[iy][src][:, :, lp + nxl - h:lp + nxl]))
        for src, dst in up:
            pairs.append((tiles[iy][dst][:, :, lp + nxl:lp + nxl + h],
                          tiles[iy][src][:, :, lp:lp + h]))
    return pairs


def _same_view(a, b):
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride())


class _Done:
    def __init__(self, fn=None):
        self.fn = fn

    def wait(self):
        if self.fn is not None:
            self.fn()


class Loopback:
    """One simulated process's transport: a send stores a copy of its
    packed buffer in the shared ``box`` under (from, to, tag); a receive's
    wait takes it out into its buffer."""

    def __init__(self, box: dict, rank: int):
        self.box, self.rank = box, rank

    def isend(self, buf, peer, tag):
        key = (self.rank, peer, tag)
        assert key not in self.box
        self.box[key] = buf.clone()
        return _Done()

    def irecv(self, buf, peer, tag):
        return _Done(lambda: buf.copy_(self.box.pop((peer, self.rank, tag))))


def _run_split(exchanges):
    """Run the processes' exchanges phase by phase, as a group does: every
    process starts a phase (receives posted, sends packed and sent, local
    copies made) before any finishes it."""
    for i in range(len(exchanges[0].phases)):
        for ex in exchanges:
            ex.start(i)
        for ex in exchanges:
            ex.finish(i)


@pytest.mark.parametrize("case", SPLITS, ids=[_split_id(c) for c in SPLITS])
def test_halo_split_matches_the_global_pieces(case):
    """Each piece of the global list is one local copy on the process that
    owns both ends, or one send and one receive with the piece's index as
    their tag and the same shape; one process keeps every piece as a copy,
    exactly the single-controller exchange's copies in its order (4 a
    shard)."""
    mesh, n_procs = case
    py, px = _shape(mesh)
    layout = TileLayout(NYL, NXL, 2)
    pieces = halo_pieces(py, px, layout)
    assert len(pieces) == 4 * py * px
    procs = _procs(py, px, n_procs)
    copies, sends, recvs = {}, {}, {}
    for rank in range(n_procs):
        tiles = [[torch.zeros(layout.shape) if procs[iy, ix] == rank else None
                  for ix in range(px)] for iy in range(py)]
        ex = HaloExchange(tiles, layout, procs, rank=rank, transport=Loopback({}, rank))
        assert ex.remote == (n_procs > 1 and any(
            procs[p.dst] != procs[p.src] for p in pieces))
        for ph in ex.phases:
            copies[rank] = copies.get(rank, 0) + len(ph.copies)
            for m in ph.sends:
                sends[m.tag] = (rank, m.peer, tuple(m.view.shape), tuple(m.host.shape))
                assert m.host.is_contiguous()
            for m in ph.recvs:
                recvs[m.tag] = (m.peer, rank, tuple(m.view.shape), tuple(m.host.shape))
        if n_procs == 1:
            old = _old_pairs(tiles, layout)
            assert len(ex.pairs) == len(old) == len(pieces)
            assert all(_same_view(a, c) and _same_view(b, d)
                       for (a, b), (c, d) in zip(ex.pairs, old))
    for tag, p in enumerate(pieces):
        src, dst = int(procs[p.src]), int(procs[p.dst])
        if src == dst:
            assert tag not in sends and tag not in recvs
        else:
            assert sends[tag] == recvs[tag]
            assert sends[tag][:2] == (src, dst)
    assert set(sends) == set(recvs)
    assert sum(copies.values()) + len(sends) == len(pieces)


@pytest.mark.parametrize("h", [1, 4], ids=["h1", "hK"])
@pytest.mark.parametrize("case", SPLITS, ids=[_split_id(c) for c in SPLITS])
def test_halo_split_fills_halos_as_one_process(case, h):
    """Each simulated process holds only its own tiles; the loopback carries
    the packed pieces; every tile's padded buffer ends bitwise as the
    one-process exchange leaves it."""
    mesh, n_procs = case
    py, px = _shape(mesh)
    layout = TileLayout(NYL, NXL, h)
    rng = np.random.default_rng(py * 10 + px + h)
    start = [[torch.from_numpy(rng.random(layout.shape, dtype=np.float32))
              for _ in range(px)] for _ in range(py)]
    want = [[t.clone() for t in row] for row in start]
    HaloExchange(want, layout)()
    procs = _procs(py, px, n_procs)
    box: dict = {}
    held, exchanges = [], []
    for rank in range(n_procs):
        tiles = [[start[iy][ix].clone() if procs[iy, ix] == rank else None
                  for ix in range(px)] for iy in range(py)]
        held.append(tiles)
        exchanges.append(HaloExchange(tiles, layout, procs, rank=rank,
                                      transport=Loopback(box, rank)))
    _run_split(exchanges)
    assert not box
    for rank, tiles in enumerate(held):
        for iy in range(py):
            for ix in range(px):
                if procs[iy, ix] == rank:
                    assert torch.equal(tiles[iy][ix], want[iy][ix]), (rank, iy, ix)


GHOST_SPLITS = [(py, p) for py in (1, 2, 4, 8) for p in (1, 2, 4) if py % p == 0]


@pytest.mark.parametrize("k", [1, 3], ids=["k1", "k3"])
@pytest.mark.parametrize("py, n_procs", GHOST_SPLITS,
                         ids=[f"{py}-p{p}" for py, p in GHOST_SPLITS])
def test_ghost_split_fills_ghost_rows_as_one_process(py, n_procs, k):
    """The x-tiled route's ghost rows: the global list (2 pieces a slab)
    splits into copies, sends and receives that match by tag and shape,
    and the loopback leaves every ghost buffer bitwise as the one-process
    exchange does."""
    layout = SlabLayout(4, 6, k)
    pieces = ghost_pieces(py, layout)
    assert len(pieces) == 2 * py
    rng = np.random.default_rng(py + k)
    start = [(torch.from_numpy(rng.random(layout.shape, dtype=np.float32)),
              torch.full(layout.ghost_shape, float("nan"))) for _ in range(py)]
    want = [(f.clone(), g.clone()) for f, g in start]
    GhostExchange(want, layout)()
    procs = np.arange(py) // (py // n_procs)
    box: dict = {}
    held, exchanges = [], []
    for rank in range(n_procs):
        slabs = [(f.clone(), g.clone()) if procs[i] == rank else None
                 for i, (f, g) in enumerate(start)]
        held.append(slabs)
        exchanges.append(GhostExchange(slabs, layout, procs, rank=rank,
                                       transport=Loopback(box, rank)))
    sends = {m.tag: (r, m.peer, tuple(m.view.shape))
             for r, ex in enumerate(exchanges) for ph in ex.phases for m in ph.sends}
    recvs = {m.tag: (m.peer, r, tuple(m.view.shape))
             for r, ex in enumerate(exchanges) for ph in ex.phases for m in ph.recvs}
    assert sends == recvs
    assert {t for t, p in enumerate(pieces) if procs[p.src[0]] != procs[p.dst[0]]} == set(sends)
    _run_split(exchanges)
    assert not box
    for rank, slabs in enumerate(held):
        for i, slab in enumerate(slabs):
            if slab is not None:
                assert torch.equal(slab[1], want[i][1]) and torch.equal(slab[0], want[i][0])


def test_cross_process_pieces_need_a_group():
    """Pieces that cross processes with no group and no transport raise:
    nothing gives way to local copies."""
    layout = TileLayout(NYL, NXL, 1)
    procs = np.array([[0], [1]])
    tiles = [[torch.zeros(layout.shape)], [None]]
    assert not dist.initialized()
    with pytest.raises(RuntimeError, match="process group"):
        HaloExchange(tiles, layout, procs, rank=0)


def test_mesh_ownership_over_processes(monkeypatch):
    """default_mesh and default_mesh_2d span every process, process-major;
    a process's shards go round-robin over its visible devices and
    another's have no device here; describe names the processes."""
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    one = mesh_mod.default_mesh(4)
    assert one.processes == [0] and one.local_positions() == [(0, 0), (1, 0), (2, 0),
                                                              (3, 0)]
    monkeypatch.setattr(dist, "process_count", lambda: 2)
    monkeypatch.setattr(dist, "process_index", lambda: 1)
    m = mesh_mod.default_mesh(4)
    assert list(m.procs) == [0, 0, 1, 1]
    assert m.local_positions() == [(2, 0), (3, 0)] and m.device(0) is None
    assert m.local_devices() == [torch.device("cpu")]
    assert m.describe() == ("4 row shard(s), 4 shard(s) over 2 processes: process 0: "
                            "2 shard(s); process 1 (this one): cpu x2")
    m2 = mesh_mod.default_mesh_2d(2, 4)
    assert m2.procs.tolist() == [[0, 0, 0, 0], [1, 1, 1, 1]]
    assert m2.positions_of(0) == [(0, 0), (0, 1), (0, 2), (0, 3)]
    assert mesh_mod.default_mesh().size == 2  # one per visible device of each process
    with pytest.raises(ValueError, match="does not divide"):
        mesh_mod.default_mesh(3)
    with pytest.raises(ValueError, match="procs must lie"):
        mesh_mod.Mesh(["cpu", "cpu"], ("y",), [0, 2])


def test_multi_process_readbacks_that_gather_f_raise(monkeypatch):
    """Over several processes, readback "state" and "fields" raise with
    lbm_tpu's reason before anything runs."""
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    params = LBMParams(16, 8, 4, 10, 0.1, 0.005, 1.85)
    sim = sharded.ShardedSimulator(params, channel_box(16, 8), mesh=mesh_mod.default_mesh(2))
    monkeypatch.setattr(dist, "process_count", lambda: 2)
    for readback in ("state", "fields"):
        with pytest.raises(ValueError, match="single-controller only"):
            sim.run(readback=readback)


def test_save_sharded_with_a_missing_peer_raises(tmp_path):
    """A state that lacks shards of its mesh, in a process with no group:
    nobody would write the missing slabs, so nothing is committed."""
    params = LBMParams(16, 8, 4, 10, 0.1, 0.005, 1.85)
    f = torch.rand(9, 8, 16)
    state = sharded.ShardedState([(0, 0, f[:, :4])], (9, 8, 16),
                                 positions=[(0, 0, (9, 4, 16)), (4, 0, (9, 4, 16))])
    assert not state.complete
    with pytest.raises(RuntimeError, match="no process group"):
        ckpt.save_sharded(tmp_path, params, channel_box(16, 8), 4, state, np.ones(4))
    assert ckpt.load(tmp_path) is None
    with pytest.raises(RuntimeError, match="single-controller only"):
        state.cpu()
    whole = dataclasses.replace(state, tiles=[(0, 0, f[:, :4]), (4, 0, f[:, 4:])])
    ckpt.save_sharded(tmp_path, params, channel_box(16, 8), 4, whole, np.ones(4))
    np.testing.assert_array_equal(ckpt.load(tmp_path).f, f.numpy())

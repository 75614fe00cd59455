"""The device transport of the exchange's pieces between processes
(``lbm_tpu_torch/parallel/ipc.py``), through its plain version on the CPU.

Real gloo groups of 2 and 4 processes, started as
``tests/test_torch_multihost.py`` starts them, carry every mesh of
``tests/test_torch_dist_exchange.py``'s ``SPLITS`` (and the ghost rows of
its ``GHOST_SPLITS``) through ``DeviceTransport("cpu")``: shared-memory
mailboxes, the counters' protocol, four exchanges in a row so that both
parities are reused; each process's tiles end bitwise as the one-process
exchange leaves them.  The pack and unpack plain versions are held
against piece-by-piece copies, and the kernels' device table against an
emulation of the kernels' index arithmetic.  A peer that exits, or stalls,
before it sends makes the other raise within the timeout, naming the peer
and the pieces.  The 128x64x40 multihost case runs over the plain device
transport and is held against ``lbm_tpu``'s reference run.  The kernels
themselves need the card: their test skips here.

This file is also the workers' script: ``python tests/test_torch_ipc_exchange.py
MODE RANK PORT PROCS OUT``.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from test_torch_dist_exchange import (  # noqa: E402
    GHOST_SPLITS,
    NXL,
    NYL,
    SPLITS,
    _procs,
    _shape,
    _split_id,
)

from lbm_tpu_torch.ops import fused  # noqa: E402
from lbm_tpu_torch.parallel import dist, ipc, sharded  # noqa: E402
from lbm_tpu_torch.parallel.halo import (  # noqa: E402
    GhostExchange,
    HaloExchange,
    SlabLayout,
    TileLayout,
    ghost_pieces,
    halo_pieces,
)

EXCHANGES = 4  # in a row: both parities of every mailbox used twice
HALOS = (1, 4)
GHOSTS = (1, 3)
STALL_TIMEOUT_S = 2.0
GROUP_TIMEOUT_S = 300
STEPS = 40
# test_torch_multihost.py's tolerances against lbm_tpu.
F_ATOL, AV_RTOL = 1e-6, 1e-4


def _halo_case(mesh, n_procs, h, rank, transport):
    """One process's share of a halo split: EXCHANGES exchanges over
    ``transport`` with the tiles changed between them, each held bitwise
    against the one-process exchange of all tiles; None where they agree,
    else what differs."""
    py, px = _shape(mesh)
    layout = TileLayout(NYL, NXL, h)
    rng = np.random.default_rng(py * 10 + px + h)
    want = [[torch.from_numpy(rng.random(layout.shape, dtype=np.float32))
             for _ in range(px)] for _ in range(py)]
    procs = _procs(py, px, n_procs)
    mine = [[want[iy][ix].clone() if procs[iy, ix] == rank else None for ix in range(px)]
            for iy in range(py)]
    ex = HaloExchange(mine, layout, procs, rank=rank, transport=transport)
    assert all(m.host is None for ph in ex.phases for m in ph.sends + ph.recvs)
    one = HaloExchange(want, layout)
    for i in range(EXCHANGES):
        one()
        ex()
        for iy in range(py):
            for ix in range(px):
                if mine[iy][ix] is not None and not torch.equal(mine[iy][ix], want[iy][ix]):
                    return f"exchange {i}: tile {(iy, ix)} differs"
        for iy in range(py):
            for ix in range(px):
                for t in (want[iy][ix], mine[iy][ix]):
                    if t is not None:
                        t.mul_(1.5).add_(i + 1)
    return None


def _ghost_case(py, n_procs, k, rank, transport):
    """The ghost rows' counterpart of :func:`_halo_case`."""
    layout = SlabLayout(4, 6, k)
    rng = np.random.default_rng(py + k)
    want = [(torch.from_numpy(rng.random(layout.shape, dtype=np.float32)),
             torch.full(layout.ghost_shape, float("nan"))) for _ in range(py)]
    procs = np.arange(py) // (py // n_procs)
    mine = [(f.clone(), g.clone()) if procs[i] == rank else None
            for i, (f, g) in enumerate(want)]
    ex = GhostExchange(mine, layout, procs, rank=rank, transport=transport)
    one = GhostExchange(want, layout)
    for i in range(EXCHANGES):
        one()
        ex()
        for j, slab in enumerate(mine):
            if slab is not None and not (torch.equal(slab[0], want[j][0])
                                         and torch.equal(slab[1], want[j][1])):
                return f"exchange {i}: slab {j} differs"
        for j in range(py):
            want[j][0].mul_(1.5).add_(i + 1)
            if mine[j] is not None:
                mine[j][0].mul_(1.5).add_(i + 1)
    return None


def _cases(n_procs):
    """``(id, run(rank, transport))`` of every split over ``n_procs``."""
    out = []
    for mesh, p in SPLITS:
        if p == n_procs:
            for h in HALOS:
                out.append((f"{_split_id((mesh, p))}-h{h}",
                            lambda r, t, mesh=mesh, h=h: _halo_case(mesh, n_procs, h, r, t)))
    for py, p in GHOST_SPLITS:
        if p == n_procs:
            for k in GHOSTS:
                out.append((f"ghost-{py}-p{p}-k{k}",
                            lambda r, t, py=py, k=k: _ghost_case(py, n_procs, k, r, t)))
    return out


def _run_cases(n_procs, rank) -> dict:
    """Every split over ``n_procs`` processes, each on a transport of its
    own, closed after it (a collective)."""
    results = {}
    for case_id, run in _cases(n_procs):
        transport = ipc.DeviceTransport("cpu", rank=rank)
        try:
            results[case_id] = run(rank, transport)
        finally:
            transport.close()
    return results


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _spawn(mode: str, n_procs: int, out: pathlib.Path, *extra: str) -> list:
    port = _free_port()
    env = dict(os.environ, LBM_DEVICE="cpu", OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    return [subprocess.Popen([sys.executable, __file__, mode, str(rank), str(port),
                              str(n_procs), str(out), *extra],
                             cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for rank in range(n_procs)]


def _finish(procs: list, timeout: float) -> list[tuple[int, str]]:
    """``(exit code, output)`` of every process; the rest killed when the
    time runs out."""
    deadline = time.monotonic() + timeout
    out = []
    for p in procs:
        try:
            text, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
        out.append((p.returncode, text))
    return out


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The groups of this module, started together: the splits over 2 and
    4 processes, a peer that exits and one that stalls, and the multihost
    case's reference then its two workers."""
    tmp = tmp_path_factory.mktemp("ipc")
    started = {f"splits{n}": (_spawn("splits", n, tmp / f"splits{n}"), tmp / f"splits{n}")
               for n in (2, 4)}
    for mode in ("exits", "stalls"):
        started[mode] = (_spawn(mode, 2, tmp / mode), tmp / mode)
    work = tmp / "smoke"
    work.mkdir()
    common = ["--procs", "2", "--local-devices", "2", "--grid", "128x64", "--steps",
              str(STEPS), "--kernel", "reference", "--workdir", str(work)]
    env = dict(os.environ, LBM_DEVICE="cpu", OMP_NUM_THREADS="1")
    single = subprocess.run([sys.executable, "-m", "lbm_tpu_torch.tools.multihost_smoke",
                             "--single", *common], cwd=ROOT, env=env, capture_output=True,
                            text=True, timeout=GROUP_TIMEOUT_S)
    assert single.returncode == 0, single.stdout + single.stderr
    started["smoke"] = (_spawn("smoke", 2, work, *common), work)
    done = {}
    for name, (procs, out) in started.items():
        done[name] = (_finish(procs, GROUP_TIMEOUT_S), out)
    yield done


def _case_ids(n_procs):
    return [case_id for case_id, _ in _cases(n_procs)]


@pytest.mark.parametrize("case_id", _case_ids(1))
def test_ipc_exchange_one_process(case_id):
    """A group of one: no piece crosses, the transport set up with no
    mailbox, every piece a local copy as the one-process exchange makes."""
    run = dict(_cases(1))[case_id]
    transport = ipc.DeviceTransport("cpu", rank=0)
    try:
        assert run(0, transport) is None
    finally:
        transport.close()
    assert transport.sizes == {}


@pytest.mark.parametrize("n_procs, case_id",
                         [(n, c) for n in (2, 4) for c in _case_ids(n)],
                         ids=[f"p{n}-{c}" for n in (2, 4) for c in _case_ids(n)])
def test_ipc_exchange_matches_one_process(groups, n_procs, case_id):
    """Every process of a real gloo group of ``n_procs`` holds its tiles
    (halos, corners, ghost rows) bitwise as the one-process exchange
    leaves them after each of EXCHANGES exchanges over the device
    transport's plain version."""
    results, out = groups[f"splits{n_procs}"]
    for rank, (code, text) in enumerate(results):
        assert code == 0, text
        got = json.loads((out.parent / f"{out.name}.rank{rank}.json").read_text())
        assert got[case_id] is None, (rank, got[case_id])


@pytest.mark.parametrize("mode", ["exits", "stalls"])
def test_dead_peer_raises_within_the_timeout(groups, mode):
    """A peer that exits after the setup, or stays alive and never sends:
    the other's receive raises within the timeout (at once for a peer
    that is gone), naming the peer and the pieces."""
    results, out = groups[mode]
    assert results[0][0] == 0, results[0][1]
    got = json.loads((out.parent / f"{out.name}.rank0.json").read_text())
    assert got["error"] == "TimeoutError"
    assert "of process 1 (pid" in got["message"] and "phase 0, pieces [" in got["message"]
    if mode == "exits":
        assert "has exited" in got["message"] and got["seconds"] < STALL_TIMEOUT_S
    else:
        assert f"sent nothing for {STALL_TIMEOUT_S:g} s" in got["message"]
        assert STALL_TIMEOUT_S <= got["seconds"] < STALL_TIMEOUT_S + 5


def test_multihost_over_the_device_transport(groups):
    """The 128x64x40 case of ``test_torch_multihost.py`` with its pieces
    over the device transport's plain version: both workers passed their
    checks (f bitwise the single-device run, av bitwise the same mesh in
    one process, the resume) on the ``ipc`` transport, and timed the
    exchange over it and over gloo; the snapshot they committed is within
    the multihost test's tolerances of ``lbm_tpu``'s reference run."""
    from lbm_tpu.config import LBMParams as JaxParams
    from lbm_tpu.geometry import channel_box as jax_channel_box
    from lbm_tpu.runtime import Simulator as JaxSimulator
    from lbm_tpu_torch import checkpoint as ckpt

    results, work = groups["smoke"]
    for code, text in results:
        assert code == 0, text
        assert "PASS" in text
    for rank in range(2):
        report = json.loads((work / f"rank{rank}.json").read_text())
        assert report["transport"] == "ipc"
        assert set(report["exchange"]) == {"ipc", "gloo"}
        assert report["send_channels"] == 1 and report["pieces"] == 4
    ours = ckpt.load(work / "ck")
    assert ours.step == STEPS
    params = JaxParams(128, 64, STEPS, 10, 0.1, 0.005, 1.85)
    ref = JaxSimulator(params, jax_channel_box(128, 64, interior_row=29),
                       kernel="reference").run()
    np.testing.assert_allclose(ours.f, np.asarray(ref.f), rtol=0, atol=F_ATOL)
    np.testing.assert_allclose(ours.av_vels, np.asarray(ref.av_vels), rtol=AV_RTOL)


def _channel(views):
    class _M:
        def __init__(self, tag, view):
            self.tag, self.peer, self.view = tag, 1, view

    return ipc.Channel.of(1, 0, [_M(i, v) for i, v in enumerate(views)])


def _pieces(kind: str, h: int):
    """Two tiles' buffers and a message of their y-phase (h owned rows of
    the owned columns) or x-phase (h columns over every padded row)
    pieces, as a 2 x 2 mesh over two processes sends them."""
    layout = TileLayout(NYL, NXL, h)
    rng = np.random.default_rng(h + (kind == "x"))
    bufs = [torch.from_numpy(rng.random(layout.shape, dtype=np.float32)) for _ in range(2)]
    pieces = [p for p in halo_pieces(2, 2, layout) if p.phase == (kind == "x")]
    views = [bufs[i % 2][p.src_index] for i, p in enumerate(pieces[:2])]
    return bufs, views


@pytest.mark.parametrize("h", [1, 4], ids=["h1", "hK"])
@pytest.mark.parametrize("kind", ["y", "x"])
def test_pack_and_unpack_plain_are_piece_copies(kind, h):
    """The pack's plain version lays the pieces out one after the other
    as their contiguous copies; the unpack's puts them back; neither
    launches a kernel on the CPU."""
    bufs, views = _pieces(kind, h)
    ch = _channel(views)
    assert ch.numel == sum(v.numel() for v in views) and ch.table is None
    assert all(v.dim() == 3 for v in views)
    assert kind == "y" or not views[0].is_contiguous()
    launches = dict(fused.LAUNCHES)
    box = torch.full((ch.numel + 5,), float("nan"))
    ipc.exchange_pack(ch, box)
    want = torch.cat([v.reshape(-1) for v in views])
    assert torch.equal(box[:ch.numel], want)
    assert torch.isnan(box[ch.numel:]).all()
    originals = [v.clone() for v in views]
    for v in views:
        v.zero_()
    before = [b.clone() for b in bufs]
    ipc.exchange_unpack(ch, box)
    for v, o in zip(views, originals):
        assert torch.equal(v, o)
    changed = sum(int((b != a).sum()) for a, b in zip(before, bufs))
    assert changed == sum(int((o != 0).sum()) for o in originals)
    assert fused.LAUNCHES == launches


@pytest.mark.parametrize("h", [1, 4], ids=["h1", "hK"])
@pytest.mark.parametrize("kind", ["y", "x", "ghost"])
def test_device_table_addresses_the_pieces(kind, h):
    """The kernels' table (``PieceRow``: address, strides, shape, offset),
    walked as ``exchange_kernel`` walks it (element e of a piece at plane
    e / (rows cols), row, column), reaches every element of every piece
    in the pack's order."""
    if kind == "ghost":
        layout = SlabLayout(6, 7, h)
        bufs = [torch.from_numpy(np.random.default_rng(h).random(layout.shape,
                                                                 dtype=np.float32))]
        views = [bufs[0][p.src_index] for p in ghost_pieces(2, layout)]
    else:
        bufs, views = _pieces(kind, h)
    ch = _channel(views)
    box = torch.empty(ch.numel)
    ipc.pack_plain(ch, box)
    emulated = torch.full_like(box, float("nan"))
    for row in ipc.table_rows(ch.views, ch.offsets):
        ptr, ps, rs, cs, planes, rows, cols, off = row
        buf = next(b for b in bufs if 0 <= ptr - b.data_ptr() < 4 * b.numel())
        first = (ptr - buf.data_ptr()) // 4
        e = np.arange(planes * rows * cols)
        k, rem = np.divmod(e, rows * cols)
        r, c = np.divmod(rem, cols)
        at = torch.from_numpy(first + k * ps + r * rs + c * cs)
        emulated[off + torch.from_numpy(e)] = buf.reshape(-1)[at]
    assert torch.equal(emulated, box)


def test_transport_choice_by_topology(monkeypatch):
    """``choose_transport``: one process none; processes of one host with
    this process's shards on one CUDA device the device transport; CPU
    shards, shards on two cards or two hosts the gloo group."""

    class FakeMesh:
        def __init__(self, *devices):
            self.devices = [torch.device(d) for d in devices]

        def local_devices(self):
            return self.devices

    assert sharded.choose_transport(FakeMesh("cpu")) == "local"
    monkeypatch.setattr(dist, "process_count", lambda: 2)
    monkeypatch.setattr(dist, "hostnames", lambda: ["a", "a"])
    assert sharded.choose_transport(FakeMesh("cuda:0", "cuda:0")) == "ipc"
    assert sharded.choose_transport(FakeMesh("cpu", "cpu")) == "gloo"
    assert sharded.choose_transport(FakeMesh("cuda:0", "cuda:1")) == "gloo"
    monkeypatch.setattr(dist, "hostnames", lambda: ["a", "b"])
    assert sharded.choose_transport(FakeMesh("cuda:0")) == "gloo"


def test_program_takes_the_chosen_transport(monkeypatch):
    """A sharded program links its exchanges to the transport it chose,
    made once: none in one process; the device transport where it
    chose ``ipc``, whose messages have no host copy."""
    from lbm_tpu_torch.config import LBMParams
    from lbm_tpu_torch.geometry import channel_box
    from lbm_tpu_torch.parallel import mesh as mesh_mod

    monkeypatch.setenv("LBM_DEVICE", "cpu")
    params = LBMParams(16, 8, 4, 10, 0.1, 0.005, 1.85)
    sim = sharded.ShardedSimulator(params, channel_box(16, 8),
                                   mesh=mesh_mod.default_mesh(2))
    program = sim.compiled()
    assert program.transport_kind == "local"
    assert program.transport() is None
    monkeypatch.setattr(program, "transport_kind", "ipc")
    bufs, _ = program.alloc()
    t = program.transport()
    assert isinstance(t, ipc.DeviceTransport) and program.transport() is t
    exchanges = program.exchanges(bufs)
    try:
        assert all(ex.transport is t for ex in exchanges)
        assert t.sizes == {}  # one process: no piece crosses
        state, av = program.run()
        ref_state, ref_av = sharded.ShardedSimulator(
            params, channel_box(16, 8), mesh=mesh_mod.default_mesh(2)).compiled().run()
        assert torch.equal(state.cpu(), ref_state.cpu()) and torch.equal(av, ref_av)
    finally:
        t.close()


def test_transport_refuses_other_messages():
    """A transport set up for one exchange's messages raises on an exchange
    whose messages differ in size."""

    class Ph:
        def __init__(self, sends, recvs):
            self.number, self.sends, self.recvs = 0, sends, recvs

    class M:
        def __init__(self, n):
            self.tag, self.peer, self.view = 0, 0, torch.zeros(9, 1, n)

    t = ipc.DeviceTransport("cpu", rank=1, timeout=1.0)
    t.sizes = {("send", 0, 0): 9 * 4}
    with pytest.raises(ValueError, match="other messages"):
        t.link([Ph([M(5)], [])])


def test_kernels_match_plain_on_the_card():
    """On the card: ``lbm_exchange_pack`` and ``lbm_exchange_unpack``
    bitwise their plain versions on y and x pieces (chip_smoke.py phase
    12 holds them at the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the exchange kernels have no CPU mode")
    for kind in ("y", "x"):
        for h in (1, 4):
            layout = TileLayout(NYL, NXL, h)
            bufs = [torch.rand(layout.shape, device="cuda") for _ in range(2)]
            pieces = [p for p in halo_pieces(2, 2, layout) if p.phase == (kind == "x")]
            ch = _channel([bufs[i % 2][p.src_index] for i, p in enumerate(pieces[:2])])
            box = torch.zeros(ch.numel, device="cuda")
            plain = torch.zeros_like(box)
            ipc.exchange_pack(ch, box)
            ipc.pack_plain(ch, plain)
            assert torch.equal(box, plain)
            want = [b.clone() for b in bufs]
            for v in ch.views:
                v.zero_()
            ipc.exchange_unpack(ch, box)
            assert all(torch.equal(a, b) for a, b in zip(bufs, want))


def _worker(mode: str, rank: int, port: int, n_procs: int, out: str, extra: list) -> int:
    if mode == "smoke":
        from lbm_tpu_torch.tools import multihost_smoke

        # The device transport's plain version on the CPU shards, which the
        # topology alone gives the gloo group.
        sharded.choose_transport = lambda mesh: "ipc"
        return multihost_smoke.main([*extra, "--rank", str(rank), "--port", str(port)])
    dist.initialize(f"127.0.0.1:{port}", n_procs, rank)
    path = pathlib.Path(f"{out}.rank{rank}.json")
    if mode == "splits":
        try:
            path.write_text(json.dumps(_run_cases(n_procs, rank)))
        finally:
            dist.shutdown()
        return 0
    # A peer that exits after the setup, or stays but never sends.
    layout = TileLayout(NYL, NXL, 1)
    procs = np.arange(2).reshape(2, 1)
    tiles = [[torch.zeros(layout.shape) if procs[iy, 0] == rank else None]
             for iy in range(2)]
    transport = ipc.DeviceTransport("cpu", timeout=STALL_TIMEOUT_S)
    ex = HaloExchange(tiles, layout, procs, transport=transport)
    if rank == 1:
        if mode == "stalls":
            time.sleep(STALL_TIMEOUT_S + 3)
        os._exit(0)
    ex.start(0)
    tic = time.monotonic()
    try:
        ex.finish(0)
        rec = {"error": None}
    except TimeoutError as e:
        rec = {"error": type(e).__name__, "message": str(e)}
    rec["seconds"] = time.monotonic() - tic
    path.write_text(json.dumps(rec))
    os._exit(0)


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                     sys.argv[5], sys.argv[6:]))

"""The persistent in-place pass of the x-tiled kernel, its shard entry and
the megakernel (``lbm::inplace_pass``, ``csrc/lbm_persistent.cuh``),
emulated in torch in its walk order, against the plain band algorithm
(``_InPlaceTemporal._plain_pass``) and ``lbm_tpu``'s x-tiled and mega
kernels; the footprint every in-place route shares with the temporal
kernel; the persistent grid they are given; and the copy widths their
sources narrow to.

The emulation runs what the kernel runs, one tile at a time: G blocks walk
tiles b, b + G, ...; each block copies its first window before any tile
stores, and tile t + G's window before tile t's centre and band cells are
stored (the copy the kernel issues during tile t's last step).  Each window
chunk of ``vec`` cells takes its source (f, the row or column bands of the
pass's parity, or the ghost rows) from its first cell, as the kernel
chooses it once per chunk.  So a chunk that straddled two sources, a halo
read from f that another tile has already rewritten, or a band cell stored
to the wrong slot shows here as f or the bands off by more than nothing.
The megakernel runs T such passes in one launch with a grid barrier
between them: every block's first window of pass p + 1 is copied after
every tile of pass p has stored, so T emulated passes in a row are its
walk, the bands' parity flipping inside the launch.
The CUDA kernels are held against the plain version on the card by
``chip_smoke.py``.  Tolerances: f and the bands bitwise (every cell runs the
same operations on the same values); av within 1e-6 relative (tiles add in
walk order), as on the card; against the Pallas kernels, the x-tiled tests'
(x-tiled f rtol 1e-5 / atol 1e-9, av rtol 1e-5; mega f rtol 1e-5 / atol
1e-7, av rtol 1e-4).
"""

import contextlib
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbm_tpu
import lbm_tpu.ops.fused as jfused
from lbm_tpu_torch import tuning
from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.geometry import channel_box, free_cells_of
from lbm_tpu_torch.ops import _build, fused, schedule
from lbm_tpu_torch.ops.lattice import NSPEEDS
from lbm_tpu_torch.ops.reference import init_cells
from lbm_tpu_torch.parallel import sharded
from lbm_tpu_torch.parallel.halo import SlabLayout
from lbm_tpu_torch.parallel.mesh import default_mesh
from lbm_tpu_torch.testing import gate_case

CPU = torch.device("cpu")
AV_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The grids here are small, and the suite runs in parallel workers:
    intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fcinv(obstacles):
    return np.float32(1.0) / np.float32(free_cells_of(obstacles))


def _vec(nx, bx, k):
    """The kernel's copy width at aligned base addresses: the largest of 4,
    2, 1 floats dividing the row stride, BX and K (``lbm::pass_vec``)."""
    return next(v for v in (4, 2, 1) if nx % v == 0 and bx % v == 0 and k % v == 0)


def _window_index(prog, t, vec, sizes):
    """Per window cell of tile ``t``: its index into one plane of the
    concatenated sources (f, RB, CB, ghost rows; ``sizes`` their plane
    sizes) and its mask index, the source chosen once per chunk of ``vec``
    cells by the chunk's first cell, as ``issue_inplace_window`` does."""
    k, by, bx, rows, nx = prog.ksteps, prog.by, prog.bx, prog.rows, prog.params.nx
    tx_n = prog.tiles[1]
    ty, tx = divmod(t, tx_n)
    wy, wx = by + 2 * k, bx + 2 * k
    assert wx % vec == 0
    f_n, rb_n, cb_n = sizes
    ly = (ty * by - k + torch.arange(wy))[:, None]  # [wy, 1] slab rows
    gx = (tx * bx - k + vec * torch.arange(wx // vec))[None, :] % nx  # [1, chunks]
    if prog.shard_entry:
        out = (ly < 0) | (ly >= rows)
        sy = ly.clamp(0, rows - 1)
    else:
        out = torch.zeros_like(ly, dtype=torch.bool)
        sy = ly % rows
    oy, ox = sy // by, gx // bx
    own = ~out & (oy == ty) & (ox == tx)
    in_rb = ~out & (oy != ty)
    in_cb = ~out & (oy == ty) & (ox != tx)
    r, c = sy - oy * by, gx - ox * bx
    # Every halo chunk lies in its owner's band (the in-place proof), and
    # a whole chunk in one half of it.
    assert not (in_rb & ~fused._in_band(r, by, k)).any()
    assert not (in_cb & ~fused._in_band(c, bx, k)).any()
    assert not (in_cb & ~fused._in_band(c + vec - 1, bx, k)).any()
    base = torch.where(own, sy * nx + gx, torch.where(
        in_rb, f_n + (oy * prog.nbr + fused._band_slot(r, by, k)) * nx + gx,
        f_n + rb_n + sy * (tx_n * prog.nbc) + ox * prog.nbc + fused._band_slot(c, bx, k)))
    base = torch.where(out, f_n + rb_n + cb_n + torch.where(ly < 0, ly + k, ly - rows + k)
                       * nx + gx, base)
    mask_row = ly + k if prog.shard_entry else sy
    lanes = torch.arange(vec)
    idx = (base[..., None] + lanes).reshape(wy, wx)
    midx = ((mask_row * nx + gx)[..., None] + lanes).reshape(wy, wx)
    return idx, midx


def _emulated_pass(prog, carry, av_out, ghost, blocks, vec):
    """One in-place pass of ``prog`` on ``carry`` in the persistent kernel's
    walk order by ``blocks`` blocks; ``ghost`` [9, 2K, nx] for the shard
    entry (None: rows wrap).  Writes f, the bands of the next parity and
    ``av_out`` (the sums times the program's av scale)."""
    f, p = carry.f, carry.parity
    k, by, bx, ny = prog.ksteps, prog.by, prog.bx, prog.params.ny
    ty_n, tx_n = prog.tiles
    tiles = ty_n * tx_n
    rb_in, cb_in = prog._views(carry.bands[p])
    rb_out, cb_out = prog._views(carry.bands[p ^ 1])
    mask = (prog.mask_ext if prog.shard_entry else prog.fluid).bool().reshape(-1)
    g = (ghost if ghost is not None else f.new_empty(NSPEEDS, 0, 1)).reshape(NSPEEDS, -1)
    sizes = (f[0].numel(), rb_in[0].numel(), cb_in[0].numel())
    ctr = (..., slice(k, k + by), slice(k, k + bx))
    band_r = [r for r in range(by) if r < k or r >= by - k]
    band_c = [c for c in range(bx) if c < k or c >= bx - k]
    slot_r = fused._band_slot(torch.tensor(band_r), by, k)
    slot_c = fused._band_slot(torch.tensor(band_c), bx, k)

    def copy(t):
        # What the copy reads, as it stands now.
        src = torch.cat([f.reshape(NSPEEDS, -1), rb_in.reshape(NSPEEDS, -1),
                         cb_in.reshape(NSPEEDS, -1), g], dim=1)
        idx, midx = _window_index(prog, t, vec, sizes)
        return src[:, idx], mask[midx]

    def store(t, centre):
        ty, tx = divmod(t, tx_n)
        ys, xs = slice(ty * by, (ty + 1) * by), slice(tx * bx, (tx + 1) * bx)
        f[:, ys, xs] = centre
        rb_out[:, ty * prog.nbr + slot_r, xs] = centre[:, band_r, :]
        cb_out[:, ys, tx * prog.nbc + slot_c] = centre[:, :, band_c]

    sums = torch.zeros(k, dtype=torch.float32)
    windows = {b: copy(b) for b in range(min(blocks, tiles))}
    for j in range(-(-tiles // blocks)):
        for b in range(blocks):
            t = b + j * blocks
            if t >= tiles:
                continue
            w, m = windows[b]
            rows_w = prog.row0 + (t // tx_n) * by - k + torch.arange(by + 2 * k)
            kick = (rows_w % ny == ny - 2)[:, None]
            w, step_sums = fused.advance_windows(w, m, kick, k, ctr, prog.params)
            if t + blocks < tiles:
                windows[b] = copy(t + blocks)
            store(t, w[ctr])
            sums += torch.stack(step_sums)
    av_out.copy_(sums * prog._av_scale)
    carry.parity = p ^ 1


def _check_pass(prog, f0, passes, blocks, vec):
    """``passes`` emulated passes of the single-device entry against the
    plain band algorithm from the same carry: f and both band parities
    bitwise, av within AV_RTOL."""
    k = prog.ksteps
    ours = prog.init(torch.as_tensor(f0).clone())
    ref = prog.init(torch.as_tensor(f0).clone())
    av, av_ref = torch.empty(passes * k), torch.empty(passes * k)
    for i in range(passes):
        _emulated_pass(prog, ours, av[i * k:(i + 1) * k], None, blocks, vec)
        prog._plain_pass(ref, av_ref[i * k:(i + 1) * k], *prog._own_edges(ref.f))
    assert ours.parity == ref.parity
    assert torch.equal(ours.f, ref.f)
    assert torch.equal(ours.bands, ref.bands)
    np.testing.assert_allclose(av.numpy(), av_ref.numpy(), rtol=AV_RTOL)


# chip_smoke.py's INPLACE_SMALL shapes and one with several tiles a block.
SHAPES = [
    (64, 96, 16, 32, 4),  # row ny-2 in a wrapped halo; 16-byte copies
    (12, 20, 4, 4, 6),    # K > BY, K > BX, 2K > BY: halos two tiles deep; 8 bytes
    (16, 24, 8, 24, 3),   # a tile as wide as the grid; K 3, 4-byte copies
    (24, 48, 4, 16, 3),   # 2K > BY, 36 tiles
]


@pytest.mark.parametrize("shape", SHAPES, ids=["wrap-kick", "k-gt-by", "one-column",
                                               "2k-gt-by"])
@pytest.mark.parametrize("blocks", ["1", "3", "tiles"])
def test_persistent_walk_matches_plain_pass(shape, blocks):
    """Three passes in walk order, at the kernel's own copy width and at
    4-byte copies (a base address off 16 bytes), bitwise the plain band
    algorithm: one block walking every tile, three blocks, and a block a
    tile."""
    ny, nx, by, bx, k = shape
    params, obstacles, f0 = gate_case(ny, nx, seed=ny + nx + k)
    prog = fused.TemporalXtStep(params, obstacles, _fcinv(obstacles), CPU, by, bx, k)
    g = prog.tiles[0] * prog.tiles[1] if blocks == "tiles" else int(blocks)
    for vec in sorted({_vec(nx, bx, k), 1}):
        _check_pass(prog, f0, 3, g, vec)


def test_persistent_walk_matches_pallas_xtiled():
    """lbm_tpu's x-tiled kernel in interpret mode (64x16, BY 4, K 2, four
    strips: ``test_plain_xtiled_matches_pallas_xtiled``'s first case)
    against four emulated passes by three blocks."""
    params = LBMParams(64, 16, 8, 10, 0.1, 0.01, 1.85)
    obstacles = channel_box(64, 16, interior_row=9)
    fcinv = _fcinv(obstacles)
    by, ksteps, px, passes = 4, 2, 4, 4
    program = jfused.build_temporal_xtiled_program(
        lbm_tpu.LBMParams(**dataclasses.asdict(params)), obstacles, fcinv, by=by,
        ksteps=ksteps, px=px, interpret=True)
    jstep = jax.jit(program.step)
    f0 = init_cells(params)
    jcarry = program.init(jnp.asarray(f0.numpy()))
    prog = fused.TemporalXtStep(params, obstacles, fcinv, CPU, by, params.nx // px, ksteps)
    carry = prog.init(f0.clone())
    av = torch.empty(passes * ksteps)
    javs = []
    for i in range(passes):
        jcarry, jav = jstep(jcarry)
        javs.append(np.asarray(jav))
        _emulated_pass(prog, carry, av[i * ksteps:(i + 1) * ksteps], None, 3,
                       _vec(params.nx, prog.bx, ksteps))
    np.testing.assert_allclose(carry.f.numpy(), np.asarray(program.final(jcarry)),
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(av.numpy(), np.concatenate(javs), rtol=1e-5)


def _check_mega(prog, f0, launches, blocks, vec):
    """``launches`` emulated megakernel launches (T passes each in walk
    order, a grid barrier between passes) against as many plain launches
    of ``prog`` from the same carry: f, both band parities and the parity
    bitwise, av within AV_RTOL."""
    k, n = prog.ksteps, launches * prog.chunk
    ours = prog.init(torch.as_tensor(f0).clone())
    ref = prog.init(torch.as_tensor(f0).clone())
    av, av_ref = torch.empty(n), torch.empty(n)
    for i in range(launches * prog.tpasses):
        _emulated_pass(prog, ours, av[i * k:(i + 1) * k], None, blocks, vec)
    launch = prog.bind_carry(ref, av_ref)
    for i in range(launches):
        launch(i)
    assert ours.parity == ref.parity == (launches * prog.tpasses) & 1
    assert torch.equal(ours.f, ref.f)
    assert torch.equal(ours.bands, ref.bands)
    np.testing.assert_allclose(av.numpy(), av_ref.numpy(), rtol=AV_RTOL)


@pytest.mark.parametrize("shape, tpasses", list(zip(SHAPES, (2, 3, 2, 3))),
                         ids=["wrap-kick", "k-gt-by", "one-column", "2k-gt-by"])
@pytest.mark.parametrize("blocks", ["1", "3", "tiles"])
def test_mega_walk_matches_plain_launch(shape, tpasses, blocks):
    """Two megakernel launches of T = 2 or 3 passes (the bands' parity
    flips inside a launch, and with T odd across launches too) in walk
    order by one block, three blocks and a block a tile, at the kernel's
    copy width, bitwise ``MegaStep``'s plain launches in f and both band
    parities."""
    ny, nx, by, bx, k = shape
    params, obstacles, f0 = gate_case(ny, nx, seed=ny + nx + k + 1)
    prog = fused.MegaStep(params, obstacles, _fcinv(obstacles), CPU, by, bx, k, tpasses)
    g = prog.tiles[0] * prog.tiles[1] if blocks == "tiles" else int(blocks)
    _check_mega(prog, f0, 2, g, _vec(nx, bx, k))


def test_mega_walk_matches_pallas_mega():
    """lbm_tpu's megakernel in interpret mode (test_fused.py's wrap-kick
    case: 128x24, BY 4, K 2, T 2, the kick row in a wrapped south halo)
    against three emulated launches by three blocks."""
    params = LBMParams(128, 24, 12, 10, 0.1, 0.01, 1.85)
    obstacles = channel_box(128, 24)
    fcinv = _fcinv(obstacles)
    by, ksteps, tpasses = 4, 2, 2
    program = jfused.build_mega_program(
        lbm_tpu.LBMParams(**dataclasses.asdict(params)), obstacles, fcinv, by=by,
        ksteps=ksteps, tpasses=tpasses, interpret=True)
    jstep = jax.jit(program.step)
    f0 = init_cells(params)
    jcarry = program.init(jnp.asarray(f0.numpy()))
    prog = fused.MegaStep(params, obstacles, fcinv, CPU, by, 32, ksteps, tpasses)
    carry = prog.init(f0.clone())
    n = params.max_iters // prog.chunk
    av = torch.empty(n * prog.chunk)
    javs = []
    for i in range(n * tpasses):
        if i % tpasses == 0:
            jcarry, jav = jstep(jcarry)
            javs.append(np.asarray(jav))
        _emulated_pass(prog, carry, av[i * ksteps:(i + 1) * ksteps], None, 3,
                       _vec(params.nx, prog.bx, ksteps))
    np.testing.assert_allclose(carry.f.numpy(), np.asarray(program.final(jcarry)),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(av.numpy(), np.concatenate(javs), rtol=1e-4)


@pytest.mark.parametrize(
    "ny, nx, by, bx, k",
    [(48, 40, 2, 8, 5),   # K > BY: the ghost rows span three tile rows; 4-byte copies
     (32, 64, 8, 16, 2),  # row ny-2 in the north slab; 8-byte copies
     (64, 32, 2, 32, 3)],  # one tile column, 2K > BY
    ids=["k-gt-by", "kick", "one-column"],
)
@pytest.mark.parametrize("blocks", ["1", "3"])
def test_persistent_walk_shard_entry_over_two_rows(ny, nx, by, bx, k, blocks,
                                                  monkeypatch):
    """The shard entry over 2 row shards, three passes: before each, each
    slab's ghost rows from its neighbours' f (the south's last K rows, the
    north's first K); each slab's emulated pass bitwise its plain pass,
    and the whole grid bitwise the single-device plain x-tiled program."""
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    params, obstacles, f0 = gate_case(ny, nx, seed=ny + k)
    params = dataclasses.replace(params, max_iters=3 * k)
    fcinv = _fcinv(obstacles)
    prog = sharded._xt_program(params, obstacles, fcinv, default_mesh(2), 3 * k, by, bx, k)
    shards = [row[0] for row in prog.shards]
    layout = prog.layout
    assert all(isinstance(s, fused.ShardTemporalXtStep) and s.shard_entry for s in shards)
    nyl = layout.nyl
    carries = [s.init(torch.as_tensor(f0[:, i * nyl:(i + 1) * nyl]).clone())
               for i, s in enumerate(shards)]
    refs = [s.init(torch.as_tensor(f0[:, i * nyl:(i + 1) * nyl]).clone())
            for i, s in enumerate(shards)]
    sums = [torch.empty(3 * k) for _ in shards]
    sums_ref = [torch.empty(3 * k) for _ in shards]

    def ghosts(cs, i):
        south, north = cs[(i - 1) % 2].f, cs[(i + 1) % 2].f
        return torch.cat([south[:, nyl - k:], north[:, :k]], dim=1)

    for p in range(3):
        gs = [ghosts(carries, i) for i in range(2)]
        gs_ref = [ghosts(refs, i) for i in range(2)]
        for i, s in enumerate(shards):
            _emulated_pass(s, carries[i], sums[i][p * k:(p + 1) * k], gs[i], int(blocks),
                           _vec(nx, bx, k))
            s._plain_pass(refs[i], sums_ref[i][p * k:(p + 1) * k], gs_ref[i], s.mask_ext)
    for c, r in zip(carries, refs):
        assert torch.equal(c.f, r.f) and torch.equal(c.bands, r.bands)
    for s, s_ref in zip(sums, sums_ref):
        np.testing.assert_allclose(s.numpy(), s_ref.numpy(), rtol=AV_RTOL)
    single = fused.TemporalXtStep(params, obstacles, fcinv, CPU, by, bx, k)
    f1, _ = single.plain_launch(torch.as_tensor(f0))
    for _ in range(2):
        f1, _ = single.plain_launch(f1)
    assert torch.equal(torch.cat([c.f for c in carries], dim=1), f1)


TILE = (8, 256, 2)  # the one-tile window took it; the persistent pass does not fit


def test_xtiled_routes_refuse_a_tile_only_the_one_tile_window_fits(monkeypatch):
    """8x256 at K 2, a tile the retired one-tile window took: the chooser,
    the structural check, the sweep and the sharded tile width refuse it
    for the x-tiled routes, and both x-tiled programs and the megakernel,
    now a persistent pass too, before the library is built."""
    assert not schedule.persistent_fits(*TILE)
    n = 8192
    assert not schedule.structurally_valid("xtiled", n, n, *TILE, 960)
    assert not schedule.xtiled_structurally_valid(n, n, *TILE, 960)
    assert TILE not in tuning.xtiled_candidates(n, n, 960)
    # A grid only 8x256 divides among the fixed order's tiles at K 2.
    monkeypatch.setattr(schedule, "TEMPORAL_TILES", ((8, 256),))
    monkeypatch.setattr(schedule, "TEMPORAL_K", (2,))
    assert schedule.choose_temporal_xtiled(n, n, 960, device_kind="none") is None
    # A slab width that only itself divides, whose windows fit no block.
    assert not schedule.persistent_fits(8, 254, 2)
    with pytest.raises(ValueError, match="no tile width"):
        sharded._tile_width(254, 8, 2)

    def no_build():
        raise AssertionError("built the library before refusing the tile")

    monkeypatch.setattr(_build, "load_library", no_build)
    params, obstacles, _ = gate_case(16, 512, seed=3)
    fcinv = _fcinv(obstacles)
    layout = SlabLayout(8, 512, 2)
    mask = layout.pad_mask(~obstacles, 0, 0)
    launches = dict(fused.LAUNCHES)
    for dev in (CPU, torch.device("cuda", 0)):
        with pytest.raises(ValueError, match="shared memory"):
            fused.TemporalXtStep(params, obstacles, fcinv, dev, *TILE)
        with pytest.raises(ValueError, match="shared memory"):
            fused.ShardTemporalXtStep(params, mask, layout, 0, fcinv, dev, 8, 256)
        with pytest.raises(ValueError, match="shared memory"):
            fused.MegaStep(params, obstacles, fcinv, dev, *TILE, 2)
    assert fused.LAUNCHES == launches


class _Lib:
    """The card's answers to the grid-sizing calls, stubbed."""

    sms, per_sm = 132, 1

    def __init__(self):
        self.seen = []

    def lbm_sm_count(self, device):
        self.seen.append(("sms", device))
        return self.sms

    def lbm_temporal_blocks_per_sm(self, by, bx, k, shard):
        raise AssertionError("sized the x-tiled grid from the temporal kernel")

    def lbm_temporal_xt_blocks_per_sm(self, by, bx, k, shard):
        self.seen.append((by, bx, k, shard))
        return self.per_sm

    def lbm_error_string(self, code):
        return f"error {code}".encode()


@pytest.fixture
def stub_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    lib = _Lib()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    return lib


def test_xtiled_grid_asks_the_card(stub_card):
    """``persistent_blocks`` given the x-tiled kernel's occupancy entry
    sizes the grid from it (its shard entry's with the flag at 1); a tile
    no SM holds is a ValueError, a CUDA error a RuntimeError."""
    lib, dev = stub_card, torch.device("cuda", 0)
    xt = "lbm_temporal_xt_blocks_per_sm"
    assert fused.persistent_blocks(lib, dev, 65536, 32, 64, 4, xt) == 132
    assert lib.seen == [("sms", 0), (32, 64, 4, 0)]
    lib.per_sm = 2
    assert fused.persistent_blocks(lib, dev, 1792, 4, 16, 3, xt, 1) == 264
    assert lib.seen[-1] == (4, 16, 3, 1)
    assert fused.persistent_blocks(lib, dev, 6, 16, 32, 4, xt) == 6
    lib.per_sm = 0
    with pytest.raises(ValueError, match=r"lbm_temporal_xt_blocks_per_sm\(0\) fits an SM"):
        fused.persistent_blocks(lib, dev, 512, 32, 64, 4, xt)
    lib.sms = -2
    with pytest.raises(RuntimeError,
                       match=r"grid of lbm_temporal_xt_blocks_per_sm\(0\) .* error 2"):
        fused.persistent_blocks(lib, dev, 512, 32, 64, 4, xt)


@pytest.mark.parametrize("entry", ["single", "shard"])
def test_xtiled_programs_size_their_grid_before_any_launch(entry, stub_card):
    """Both x-tiled programs, made for a device other than the CPU, take
    ``nblocks`` from the card (here a stub, tensors on the meta device):
    min(tiles, SMs x blocks an SM), asked for their own entry."""
    lib, meta = stub_card, torch.device("meta")
    lib.per_sm = 2
    params, obstacles, _ = gate_case(256, 448, seed=4)
    fcinv = _fcinv(obstacles)
    launches = dict(fused.LAUNCHES)
    if entry == "single":
        prog = fused.TemporalXtStep(params, obstacles, fcinv, meta, 4, 16, 3)
        tiles = 64 * 28
    else:
        layout = SlabLayout(128, 448, 3)
        prog = fused.ShardTemporalXtStep(params, layout.pad_mask(~obstacles, 0, 0), layout,
                                         0, fcinv, meta, 4, 16)
        tiles = 32 * 28
    assert prog.tiles[0] * prog.tiles[1] == tiles
    assert prog.nblocks == min(tiles, 132 * 2) == 264
    assert lib.seen[-1] == (4, 16, 3, int(entry == "shard"))
    assert fused.LAUNCHES == launches
    # The CPU program sizes nothing.
    assert fused.TemporalXtStep(params, obstacles, fcinv, CPU, 4, 16, 3).nblocks == 0


def test_mega_sizes_its_grid_from_its_own_occupancy(stub_card):
    """``MegaStep``, made for a device other than the CPU, takes
    ``nblocks`` from ``lbm_mega_num_blocks`` (the megakernel's own
    occupancy at the persistent footprint: a cooperative launch needs every
    block co-resident), not from the x-tiled kernel's; a card that admits
    no cooperative launch (-1) or no block (0) is a ValueError."""
    lib, meta = stub_card, torch.device("meta")

    def mega_num_blocks(ny, nx, by, bx, k):
        lib.seen.append(("mega", ny, nx, by, bx, k))
        return lib.mega

    lib.lbm_mega_num_blocks = mega_num_blocks
    lib.mega = 264
    params, obstacles, _ = gate_case(256, 448, seed=5)
    fcinv = _fcinv(obstacles)
    launches = dict(fused.LAUNCHES)
    prog = fused.MegaStep(params, obstacles, fcinv, meta, 4, 16, 3, 2)
    assert prog.nblocks == 264 and prog.tiles == (64, 28)
    assert lib.seen == [("mega", 256, 448, 4, 16, 3)]
    for answer in (-1, 0):
        lib.mega = answer
        with pytest.raises(ValueError, match="no cooperative launch"):
            fused.MegaStep(params, obstacles, fcinv, meta, 4, 16, 3, 2)
    assert fused.LAUNCHES == launches
    assert fused.MegaStep(params, obstacles, fcinv, CPU, 4, 16, 3, 2).nblocks == 0


def test_xtiled_copies_narrow_to_every_base_address():
    """Both x-tiled entries build their geometry with ``inplace_geom``,
    whose copy width follows the base addresses of f, both band parities,
    the ghost rows and the mask (``lbm::pass_vec`` over the row stride, BX
    and K), and refuse a float pointer off 4 bytes; the pass copies by
    that width and picks each chunk's source once."""
    csrc = _build.SOURCES[0].parent

    def flat(text):  # the source with its whitespace collapsed
        return re.sub(r"\s+", " ", text)

    xt = flat((csrc / "lbm_temporal_xt.cu").read_text())
    body = re.search(r"lbm::InPlaceGeom inplace_geom\((.*?)\) \{(.*?) return g; \}", xt)
    assert body is not None
    args, code = body.groups()
    assert ("const float* f, const float* b0, const float* b1, const float* ghost, "
            "const uint8_t* mask") in args
    for ptr in ("b0", "b1", "ghost"):
        assert f"reinterpret_cast<uintptr_t>({ptr})" in code
    assert ("g.vec = (bases & 3) ? -1 : lbm::pass_vec(nx, bx, ksteps, "
            "static_cast<int>(bases >> 2 & 3), f, mask);") in code
    assert ("inplace_geom(p.ny, p.nx, 0, by, bx, ksteps, f, bands_in, bands_out, nullptr, "
            "fluid)") in xt
    assert ("inplace_geom(nyl, p.nx, row0, by, bx, ksteps, f, bands_in, bands_out, ghost, "
            "mask)") in xt
    for kernel in ("lbm_xt_kernel", "lbm_shard_xt_kernel"):
        assert f"lbm::launch_pass<kPassThreads>({kernel}, g, nblocks, stream" in xt
    pers = (csrc / "lbm_persistent.cuh").read_text()
    issue = flat(re.search(r"void issue_inplace_window\((.*?)\n\}\n", pers, re.S).group(1))
    assert "const int v = g.vec;" in issue
    for width in ("cp_async16", "cp_async8", "cp_async4"):
        assert f"{width}(buf + q * wcells + i, src + q * stride + off)" in issue
    assert "g.vec < 1" in pers  # launch_pass refuses a misaligned pointer

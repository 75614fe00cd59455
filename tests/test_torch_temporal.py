"""The temporal program (``TemporalStep``) against lbm_tpu's
``_step_kernel_temporal``, against K plain one-steps, the buffer parity of
its passes, the Simulator's temporal branch, its refusal to fall back, the
shapes the persistent kernel refuses, the buffer offsets it takes, and its
persistent grid.

The JAX side runs ``build_temporal_program(..., interpret=True)`` as
``tests/test_fused.py`` does.  On the CPU ``TemporalStep`` runs its plain
version, the kernel's window algorithm in torch, so a tiling fault shows
here; the CUDA kernel is held against that plain version on the card by
``chip_smoke.py``.  Tolerances as in test_torch_fused.py: f atol 1e-6, av
rtol 1e-4.  Against K plain one-steps f is bitwise equal: every cell runs
the same operations in the same order (rho summed left to right in
both); only av is summed in another order (per tile, then over tiles).
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
from lbm_tpu.ops.fused import build_temporal_program
from lbm_tpu_torch.geometry import free_cells_of
from lbm_tpu_torch.ops import _build, fused, schedule
from lbm_tpu_torch.runtime import Simulator
from lbm_tpu_torch.testing import gate_case

F_ATOL, AV_RTOL = 1e-6, 1e-4
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The grids here are small, and the suite runs in parallel workers:
    intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(ny, nx, seed):
    params, obstacles, f0 = gate_case(ny, nx, seed)
    fcinv = np.float32(1.0) / np.float32(free_cells_of(obstacles))
    return params, obstacles, f0, fcinv


def _jax_params(params):
    return lbm_tpu.LBMParams(**dataclasses.asdict(params))


def test_plain_temporal_pass_matches_pallas_kernel():
    """32x48 in 8x16 tiles, K = 4: row ny-2 = 30 lies in the top tile
    row's interior and, wrapped, in the south halo of the bottom row's
    windows (JAX's two gated kick sites)."""
    params, obstacles, f0, fcinv = _setup(32, 48, seed=51)
    program = build_temporal_program(params, obstacles, fcinv, by=8, ksteps=4,
                                     interpret=True)
    jstep = jax.jit(program.step)
    carry = program.init(jnp.asarray(f0))
    ours = fused.TemporalStep(params, obstacles, fcinv, CPU, by=8, bx=16, ksteps=4)
    assert ours.chunk == program.chunk == 4
    bufs = (torch.from_numpy(f0.copy()), torch.empty(f0.shape, dtype=torch.float32))
    av = torch.empty(12, dtype=torch.float32)
    launch = ours.bind(*bufs, av)
    launches = dict(fused.LAUNCHES)
    javs = []
    for i in range(3):
        carry, jav = jstep(carry)
        javs.append(np.asarray(jav))
        launch(i)
    np.testing.assert_allclose(av.numpy(), np.concatenate(javs), rtol=AV_RTOL)
    np.testing.assert_allclose(
        bufs[ours.final_index(3)].numpy(), np.asarray(program.final(carry)),
        rtol=0, atol=F_ATOL,
    )
    assert fused.LAUNCHES == launches  # the CPU path launches nothing


@pytest.mark.parametrize(
    "ny, nx, by, bx, ksteps",
    [
        (32, 48, 8, 16, 4),   # the chooser's kind of tiling, several tiles
        (12, 20, 4, 4, 6),    # K > BY: row ny-2 in other tiles' north halos
        (16, 24, 16, 24, 3),  # one tile: every halo wraps onto the window
        (37, 75, 37, 25, 2),  # odd sizes
    ],
    ids=["tiles", "k-gt-by", "one-tile", "odd"],
)
def test_temporal_pass_equals_k_plain_steps(ny, nx, by, bx, ksteps):
    params, obstacles, f0, fcinv = _setup(ny, nx, seed=ny + ksteps)
    prog = fused.TemporalStep(params, obstacles, fcinv, CPU, by=by, bx=bx,
                              ksteps=ksteps)
    f = torch.from_numpy(f0)
    out, avs = prog.plain_launch(f)
    ref, ref_av = f, []
    for _ in range(ksteps):
        ref, a = prog.plain(ref)
        ref_av.append(float(a))
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    np.testing.assert_allclose(avs.numpy(), ref_av, rtol=AV_RTOL)


def test_passes_flip_once_per_pass():
    """Pass i reads bufs[i & 1]: after n passes the state is in
    bufs[n & 1], whatever K; ``single`` advances one pass."""
    params, obstacles, f0, fcinv = _setup(16, 24, seed=61)
    prog = fused.TemporalStep(params, obstacles, fcinv, CPU, by=8, bx=8, ksteps=3)
    f = torch.from_numpy(f0)
    ref = f
    for _ in range(9):
        ref, _ = prog.plain(ref)
    bufs = (f.clone(), torch.empty_like(f))
    av = torch.empty(9, dtype=torch.float32)
    launch = prog.bind(*bufs, av)
    for i in range(3):
        launch(i)
    assert [prog.final_index(n) for n in range(4)] == [0, 1, 0, 1]
    np.testing.assert_array_equal(bufs[1].numpy(), ref.numpy())
    one, one_av = prog.single(f)
    assert one_av.shape == (3,)
    np.testing.assert_array_equal(one_av.numpy(), av[:3].numpy())
    with pytest.raises(ValueError, match="out of range"):
        launch(3)
    with pytest.raises(ValueError, match="does not divide"):
        fused.TemporalStep(params, obstacles, fcinv, CPU, by=5, bx=8, ksteps=3)


@pytest.mark.parametrize(
    "max_iters, passes", [(8, 2), (12, 3)], ids=["2-passes", "3-passes"]
)
def test_simulator_temporal_branch_matches_lbm_tpu(max_iters, passes, monkeypatch):
    """The chooser sends grids above the multi-step budget to the temporal
    kernel; with the budget at 0 a small grid takes that branch.  An even
    and an odd number of passes, against lbm_tpu's reference."""
    monkeypatch.setattr(schedule, "MULTISTEP_CELL_BUDGET", 0)
    params, obstacles, f0, _ = _setup(32, 48, seed=70 + max_iters)
    params = dataclasses.replace(params, max_iters=max_iters)
    sim = Simulator(params, obstacles, device=CPU)
    prog = sim.program
    assert isinstance(prog, fused.TemporalStep)
    assert schedule.choose_schedule(32, 48, max_iters) == (
        "temporal", (prog.by, prog.bx, prog.chunk)
    )
    assert max_iters // prog.chunk == passes
    ours = sim.run(f0=f0, readback="state")
    theirs = lbm_tpu.Simulator(_jax_params(params), obstacles, kernel="reference").run(
        f0=jnp.asarray(f0), readback="state"
    )
    np.testing.assert_allclose(ours.f, np.asarray(theirs.f), rtol=0, atol=F_ATOL)
    np.testing.assert_allclose(ours.av_vels, theirs.av_vels, rtol=AV_RTOL)
    assert ours.steps_per_pass == prog.chunk
    assert ours.bytes_per_update == fused.window_bytes_per_update(
        prog.by, prog.bx, prog.chunk
    )


def test_window_bytes_per_update():
    # 32x32 tiles, K = 8: a 48x48 window read (37 B a cell), the 32x32
    # centre written (36 B a cell), over 32*32*8 updates.
    assert fused.window_bytes_per_update(32, 32, 8) == (48 * 48 * 37 + 1024 * 36) / 8192
    # K = 1 on a tile the size of the grid would be the one-step's 73 B
    # plus the halo ring.
    assert fused.window_bytes_per_update(1024, 1024, 1) > schedule.BYTES_PER_CELL


def test_temporal_never_takes_the_plain_path_on_other_devices(monkeypatch):
    params, obstacles, f0, fcinv = _setup(8, 12, seed=80)
    prog = fused.TemporalStep(params, obstacles, fcinv, CPU, by=4, bx=4, ksteps=2)

    def no_plain(*args, **kwargs):
        raise AssertionError("the CUDA path fell back to the plain version")

    monkeypatch.setattr(prog, "plain_launch", no_plain)
    monkeypatch.setattr(prog, "plain", no_plain)
    f = torch.empty(f0.shape, device="meta")
    av = torch.empty(2, device="meta")

    def failing_build():
        raise _build.BuildError("simulated build failure")

    monkeypatch.setattr(_build, "load_library", failing_build)
    with pytest.raises(_build.BuildError, match="simulated"):
        prog.bind(f, torch.empty_like(f), av)
    with pytest.raises(_build.BuildError, match="simulated"):
        fused.TemporalStep(params, obstacles, fcinv, torch.device("cuda", 0),
                           by=4, bx=4, ksteps=2)
    launches = dict(fused.LAUNCHES)
    monkeypatch.setattr(_build, "load_library", lambda: object())
    with pytest.raises(ValueError, match="CUDA or CPU"):
        prog.bind(f, torch.empty_like(f), av)
    assert fused.LAUNCHES == launches


@pytest.mark.parametrize("ny, nx, tile", [(64, 128, (32, 64, 4)), (128, 96, (64, 32, 4))],
                         ids=["32x64", "64x32"])
def test_plain_pass_at_the_default_tiles_matches_pallas_kernel(ny, nx, tile):
    """The fixed order's first two tiles, each on a grid it tiles more than
    once: the plain pass of the persistent kernel against lbm_tpu's
    temporal kernel in interpret mode (row windows of BY rows), three
    passes, at test_plain_temporal_pass_matches_pallas_kernel's
    tolerances."""
    by, bx, k = schedule.fixed_temporal(ny, nx, 20000)
    assert (by, bx, k) == tile
    params, obstacles, f0, fcinv = _setup(ny, nx, seed=ny + nx)
    program = build_temporal_program(params, obstacles, fcinv, by=by, ksteps=k,
                                     interpret=True)
    jstep = jax.jit(program.step)
    carry = program.init(jnp.asarray(f0))
    ours = fused.TemporalStep(params, obstacles, fcinv, CPU, by=by, bx=bx, ksteps=k)
    assert ours.chunk == program.chunk == k
    bufs = (torch.from_numpy(f0.copy()), torch.empty(f0.shape, dtype=torch.float32))
    av = torch.empty(3 * k, dtype=torch.float32)
    launch = ours.bind(*bufs, av)
    javs = []
    for i in range(3):
        carry, jav = jstep(carry)
        javs.append(np.asarray(jav))
        launch(i)
    np.testing.assert_allclose(av.numpy(), np.concatenate(javs), rtol=AV_RTOL)
    np.testing.assert_allclose(
        bufs[ours.final_index(3)].numpy(), np.asarray(program.final(carry)),
        rtol=0, atol=F_ATOL,
    )


@pytest.mark.parametrize(
    "kwargs, match",
    [
        (dict(by=24, bx=64, ksteps=4), "does not divide"),
        (dict(by=32, bx=48, ksteps=4), "does not divide"),
        (dict(by=32, bx=64, ksteps=0), "ksteps must be"),
        (dict(by=64, bx=128, ksteps=4), "shared memory"),
        # Two fp32 windows fit; the persistent pass's footprint does not.
        (dict(by=8, bx=256, ksteps=2), "shared memory"),
        (dict(by=32, bx=64, ksteps=8), "shared memory"),
        (dict(by=0, bx=64, ksteps=4), "does not divide"),
        (dict(by=32, bx=64, ksteps=-4), "ksteps must be"),
    ],
    ids=["by", "bx", "k", "window", "window-not-xtiled", "window-k8", "by-zero",
         "k-negative"],
)
def test_temporal_refuses_shapes_before_any_launch(kwargs, match, monkeypatch):
    """Every shape the persistent kernel does not take raises ValueError
    where the program is made, on the CPU and for a CUDA device alike,
    before the library is built or anything launches."""
    params, obstacles, _, fcinv = _setup(128, 256, seed=90)

    def no_build():
        raise AssertionError("built the library before refusing the shape")

    monkeypatch.setattr(_build, "load_library", no_build)
    launches = dict(fused.LAUNCHES)
    for dev in (CPU, torch.device("cuda", 0)):
        with pytest.raises(ValueError, match=match):
            fused.TemporalStep(params, obstacles, fcinv, dev, **kwargs)
    assert fused.LAUNCHES == launches


@pytest.mark.parametrize(
    "tiles, sms, per_sm, grid",
    [
        (1, 132, 1, 1),       # one tile
        (6, 132, 1, 6),       # fewer tiles than SMs: 64x96 in 16x32 tiles
        (512, 132, 1, 132),   # 1024^2 in 32x64 tiles: 512 = 3 * 132 + 116
        (1024, 132, 2, 264),  # two blocks an SM: 1024 = 3 * 264 + 232
        (264, 132, 2, 264),   # a multiple of the grid
    ],
    ids=["one-tile", "fewer-than-sms", "remainder", "two-per-sm", "multiple"],
)
def test_persistent_grid_walks_every_tile_once(tiles, sms, per_sm, grid):
    """The grid is min(tiles, SMs x blocks an SM); block b walks tiles b,
    b + grid, ... (the kernel's loop), which covers every tile once."""
    assert fused.persistent_grid(tiles, sms, per_sm) == grid
    walked = sorted(t for b in range(grid) for t in range(b, tiles, grid))
    assert walked == list(range(tiles))


def test_persistent_blocks_asks_the_card(monkeypatch):
    """The wrapper sizes the grid from the device's SM count and the
    kernel's occupancy at the tile; a tile no SM holds is a ValueError, a
    CUDA error a RuntimeError."""
    seen = []

    class Lib:
        sms, per_sm = 132, 1

        def lbm_sm_count(self, device):
            seen.append(("sms", device))
            return self.sms

        def lbm_temporal_blocks_per_sm(self, by, bx, k, shard):
            seen.append((by, bx, k, shard))
            return self.per_sm

        def lbm_error_string(self, code):
            return f"error {code}".encode()

    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    lib, dev = Lib(), torch.device("cuda", 0)
    assert fused.persistent_blocks(lib, dev, 512, 32, 64, 4) == 132
    assert seen == [("sms", 0), (32, 64, 4, 0)]
    assert fused.persistent_blocks(lib, dev, 6, 16, 32, 4,
                                   "lbm_temporal_blocks_per_sm", 1) == 6
    assert seen[-1] == (16, 32, 4, 1)
    lib.per_sm = 0
    with pytest.raises(ValueError, match="fits an SM"):
        fused.persistent_blocks(lib, dev, 512, 32, 64, 4)
    lib.sms = -2
    with pytest.raises(RuntimeError, match="error 2"):
        fused.persistent_blocks(lib, dev, 512, 32, 64, 4)


@pytest.mark.parametrize("offset", [0, 1, 2, 3], ids=["aligned", "4B", "8B", "12B"])
def test_temporal_takes_buffers_at_any_offset(offset):
    """Bound buffers that are views ``offset`` floats into their
    allocations (contiguous, so the wrapper takes them) advance as aligned
    ones do, to the bit: the wrapper refuses no alignment, and the kernel
    narrows its window copies to the one it finds (checked on the card
    by chip_smoke.py's offset cases)."""
    params, obstacles, f0, fcinv = _setup(64, 96, seed=93)
    prog = fused.TemporalStep(params, obstacles, fcinv, CPU, by=16, bx=32, ksteps=4)

    def run(off):
        flat = [torch.empty(f0.size + off, dtype=torch.float32) for _ in range(2)]
        bufs = [x[off:].view(f0.shape) for x in flat]
        bufs[0].copy_(torch.from_numpy(f0))
        av = torch.empty(3 * 4, dtype=torch.float32)
        launch = prog.bind(*bufs, av)
        for i in range(3):
            launch(i)
        return bufs[prog.final_index(3)], av

    want_f, want_av = run(0)
    got_f, got_av = run(offset)
    assert got_f.data_ptr() % 16 == (want_f.data_ptr() + 4 * offset) % 16
    assert torch.equal(got_f, want_f) and torch.equal(got_av, want_av)


def test_window_copies_narrow_to_the_base_address():
    """The copy width (16, 8 or 4 bytes) follows the base addresses of f
    and the mask as well as the shapes, in every entry of the persistent
    pass, so a view at an offset is never copied misaligned."""
    csrc = _build.SOURCES[0].parent
    src = (csrc / "lbm_persistent.cuh").read_text()
    body = re.search(r"inline int pass_vec\((.*?)\{(.*?)\n\}", src, re.S)
    assert "const float* f, const uint8_t* mask" in body.group(1)
    assert "reinterpret_cast<uintptr_t>(f)" in body.group(2)
    assert "reinterpret_cast<uintptr_t>(mask) & 3" in body.group(2)
    assert "g.vec < 1" in src  # a float pointer off 4 bytes is refused
    assert src.count("pass_vec(") == 3  # the definition, grid_geom, shard_geom
    temporal = (csrc / "lbm_temporal.cu").read_text()
    assert "lbm::grid_geom(p.ny, p.nx, by, bx, ksteps, f_in, fluid)" in temporal
    assert "shard_geom(nyl, nxl, stride, lpad, row0, by, bx, ksteps, f_in, mask)" in temporal
    ablate = (csrc / "lbm_ablate.cu").read_text()
    assert "lbm::grid_geom(p.ny, p.nx, by, bx, ksteps, f_in, fluid)" in ablate

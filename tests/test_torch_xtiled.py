"""The in-place programs (``TemporalXtStep``, ``MegaStep``) against lbm_tpu's
``_step_kernel_temporal_xt`` and ``_step_kernel_mega``, against K plain
one-steps, the x-tiled chooser's gate against lbm_tpu's, the Simulator's
x-tiled branch and ``--kernel mega`` route, and their refusal to fall back.

The JAX side runs ``build_temporal_xtiled_program`` and
``build_mega_program`` with ``interpret=True``, as ``tests/test_fused.py``
does, at its shapes.  On the CPU the port's programs run their plain
version, the kernels' band algorithm in torch (halo from the carried bands,
f updated in place), so a band-layout fault shows here; the CUDA kernels
are held against that plain version on the card by ``chip_smoke.py``.
Tolerances: against the Pallas kernels as ``tests/test_fused.py`` holds
them against the jnp step (x-tiled f rtol 1e-5 / atol 1e-9, av rtol 1e-5;
mega f rtol 1e-5 / atol 1e-7, av rtol 1e-4): the Pallas window sums rho in
another order.  Against K plain one-steps f is bitwise equal (every cell
runs the same operations in the same order); av is summed per tile row
chunk, so rtol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbm_tpu
import lbm_tpu.ops.fused as jfused
from lbm_tpu_torch import cli, runtime
from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.geometry import channel_box, free_cells_of, write_obstacle_file
from lbm_tpu_torch.ops import _build, fused, schedule
from lbm_tpu_torch.ops.reference import init_cells
from lbm_tpu_torch.runtime import Simulator, make_program
from lbm_tpu_torch.testing import gate_case

CPU = torch.device("cpu")
AV_RTOL_STEPS = 1e-6


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


def _jax_params(params):
    return lbm_tpu.LBMParams(**dataclasses.asdict(params))


def _k4_random_geometry():
    """test_fused.py's K 4 random geometry: 10% obstacles spanning the
    strip boundaries, the kick row kept clear."""
    rng = np.random.default_rng(7)
    params = LBMParams(96, 24, 8, 10, 0.1, 0.005, 1.85)
    interior = rng.random((24, 96)) < 0.1
    interior[0, :] = interior[-1, :] = False
    interior[22, :] = False
    return params, channel_box(96, 24) | interior


@pytest.mark.parametrize(
    "case, by, ksteps, px, passes",
    [("64x16", 4, 2, 4, 4), ("k4-random", 6, 4, 2, 2)],
)
def test_plain_xtiled_matches_pallas_xtiled(case, by, ksteps, px, passes):
    """Tiles of the Pallas kernel's own (BY, strip) shape, several passes,
    the halo carried in the bands between them."""
    if case == "64x16":
        params = LBMParams(64, 16, 8, 10, 0.1, 0.01, 1.85)
        obstacles = channel_box(64, 16, interior_row=9)
    else:
        params, obstacles = _k4_random_geometry()
    fcinv = _fcinv(obstacles)
    program = jfused.build_temporal_xtiled_program(
        _jax_params(params), obstacles, fcinv, by=by, ksteps=ksteps, px=px,
        interpret=True)
    jstep = jax.jit(program.step)
    f0 = init_cells(params)
    carry = program.init(jnp.asarray(f0.numpy()))
    ours = fused.TemporalXtStep(params, obstacles, fcinv, CPU, by, params.nx // px, ksteps)
    assert ours.chunk == program.chunk == ksteps and ours.n_buffers == 1
    f = f0.clone()
    av = torch.empty(passes * ksteps, dtype=torch.float32)
    launch = ours.bind(f, av)
    launches = dict(fused.LAUNCHES)
    javs = []
    for i in range(passes):
        carry, jav = jstep(carry)
        javs.append(np.asarray(jav))
        launch(i)
    np.testing.assert_allclose(f.numpy(), np.asarray(program.final(carry)),
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(av.numpy(), np.concatenate(javs), rtol=1e-5)
    assert fused.LAUNCHES == launches  # the CPU path launches nothing


@pytest.mark.parametrize(
    "ny, nx, by, bx, ksteps",
    [
        (32, 48, 8, 16, 4),   # several tiles each way
        (12, 20, 4, 4, 6),    # K > BY and K > BX: halos span two tiles
        (16, 24, 16, 24, 3),  # one tile: every halo wraps onto itself
        (16, 24, 8, 24, 3),   # two tiles: both row halos are the other tile
        (37, 75, 37, 25, 2),  # odd sizes
    ],
    ids=["tiles", "k-gt-by", "one-tile", "two-tiles", "odd"],
)
def test_xtiled_pass_equals_k_plain_steps(ny, nx, by, bx, ksteps):
    params, obstacles, f0 = gate_case(ny, nx, seed=ny + ksteps)
    prog = fused.TemporalXtStep(params, obstacles, _fcinv(obstacles), CPU, by, bx, ksteps)
    f = torch.from_numpy(f0)
    ref, ref_av = f, []
    for _ in range(3 * ksteps):
        ref, a = prog.plain(ref)
        ref_av.append(float(a))
    out, avs = prog.plain_launch(f)
    np.testing.assert_array_equal(f.numpy(), f0)  # the input stays as it was
    one = f
    for _ in range(ksteps):
        one, _ = prog.plain(one)
    np.testing.assert_array_equal(out.numpy(), one.numpy())
    np.testing.assert_allclose(avs.numpy(), ref_av[:ksteps], rtol=AV_RTOL_STEPS)
    # Three passes in place, the bands carried from pass to pass.
    carry = prog.init(f.clone())
    av = torch.empty(3 * ksteps, dtype=torch.float32)
    launch = prog.bind_carry(carry, av)
    for i in range(3):
        launch(i)
    assert carry.parity == 1
    np.testing.assert_array_equal(carry.f.numpy(), ref.numpy())
    np.testing.assert_allclose(av.numpy(), ref_av, rtol=AV_RTOL_STEPS)
    with pytest.raises(ValueError, match="out of range"):
        launch(3)


def test_bands_hold_the_tiles_edge_cells():
    """``init`` fills parity 0 with each tile's rows and columns within K
    of its edges, in band order (``lbm_tpu``'s ``ghosts_of``)."""
    params, obstacles, f0 = gate_case(16, 24, seed=5)
    prog = fused.TemporalXtStep(params, obstacles, _fcinv(obstacles), CPU, 8, 12, 3)
    assert (prog.nbr, prog.nbc) == (6, 6)
    f = torch.from_numpy(f0)
    carry = prog.init(f)
    assert carry.f is f and carry.parity == 0 and carry.bands.shape == (2, prog.band_floats)
    rb, cb = prog._views(carry.bands[0])
    rows = [0, 1, 2, 5, 6, 7, 8, 9, 10, 13, 14, 15]
    cols = [0, 1, 2, 9, 10, 11, 12, 13, 14, 21, 22, 23]
    np.testing.assert_array_equal(rb.numpy(), f0[:, rows, :])
    np.testing.assert_array_equal(cb.numpy(), f0[:, :, cols])
    assert prog.band_floats == 9 * (12 * 24 + 16 * 12)


@pytest.mark.parametrize(
    "case, by, ksteps, tpasses",
    [("128x32", 8, 4, 1), ("128x32", 8, 4, 3), ("wrap-kick", 4, 2, 2)],
)
def test_plain_mega_matches_pallas_mega(case, by, ksteps, tpasses):
    """test_fused.py's megakernel shapes: in-place passes across launch
    boundaries, and the kick row in block 0's wrapped south halo with the
    1024^2 case's accel."""
    if case == "128x32":
        params = LBMParams(128, 32, 24, 10, 0.1, 0.005, 1.85)
        obstacles = channel_box(128, 32, interior_row=13)
    else:
        params = LBMParams(128, 24, 12, 10, 0.1, 0.01, 1.85)
        obstacles = channel_box(128, 24)
    fcinv = _fcinv(obstacles)
    program = jfused.build_mega_program(_jax_params(params), obstacles, fcinv, by=by,
                                        ksteps=ksteps, tpasses=tpasses, interpret=True)
    ours = fused.MegaStep(params, obstacles, fcinv, CPU, by, 32, ksteps, tpasses)
    assert ours.chunk == program.chunk == ksteps * tpasses
    f0 = init_cells(params)
    carry = program.init(jnp.asarray(f0.numpy()))
    f = f0.clone()
    n = params.max_iters // ours.chunk
    av = torch.empty(n * ours.chunk, dtype=torch.float32)
    launch = ours.bind(f, av)
    javs = []
    for i in range(n):
        carry, jav = program.step(carry)
        javs.append(np.asarray(jav))
        launch(i)
    np.testing.assert_allclose(f.numpy(), np.asarray(program.final(carry)),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(av.numpy(), np.concatenate(javs), rtol=1e-4)


def test_mega_launch_is_t_xtiled_passes():
    params, obstacles, f0 = gate_case(24, 32, seed=9)
    fcinv = _fcinv(obstacles)
    mega = fused.MegaStep(params, obstacles, fcinv, CPU, 8, 16, 2, 3)
    xt = fused.TemporalXtStep(params, obstacles, fcinv, CPU, 8, 16, 2)
    f = torch.from_numpy(f0)
    out, av = mega.plain_launch(f)
    carry = xt.init(f.clone())
    xav = torch.empty(6, dtype=torch.float32)
    launch = xt.bind_carry(carry, xav)
    for i in range(3):
        launch(i)
    np.testing.assert_array_equal(out.numpy(), carry.f.numpy())
    np.testing.assert_array_equal(av.numpy(), xav.numpy())
    one, one_av = mega.single(f)
    np.testing.assert_array_equal(one.numpy(), out.numpy())
    assert one_av.shape == (6,) and mega.final_index(5) == 0


@pytest.mark.parametrize(
    "ny, nx",
    [(8192, 8192), (10240, 10240), (12800, 12800), (4096, 4096), (1024, 1024),
     (8192, 8200)],
)
def test_xtiled_gate_is_lbm_tpus(ny, nx):
    """The port's x-tiled gate admits exactly the grids lbm_tpu's does, with
    its K; the tile is Hopper's (it fits a block's shared memory).  The
    schedule takes it where the ping-pong pair does not fit the device, and
    the faster row temporal kernel, at the same tile, where it does."""
    for max_iters in (20000, 1002):
        theirs = jfused.choose_temporal_xtiled(ny, nx, max_iters)
        ours = schedule.choose_temporal_xtiled(ny, nx, max_iters)
        assert (ours is None) == (theirs is None), (ny, nx, max_iters)
        if ours is not None:
            by, bx, k = ours
            assert k == theirs[1]
            assert schedule.xtiled_structurally_valid(ny, nx, by, bx, k, max_iters)
            assert schedule.choose_schedule(ny, nx, max_iters, pingpong_fits=False) == (
                "xtiled", ours)
            assert schedule.choose_schedule(ny, nx, max_iters) == ("temporal", ours)
    assert schedule.choose_temporal_xtiled(8192, 8192, 1001) is None
    assert not schedule.xtiled_structurally_valid(8192, 8192, 32, 64, 4, 1002)
    assert not schedule.xtiled_structurally_valid(8192, 8192, 256, 256, 4, 20000)


def test_xtiled_branch_is_lbm_tpus_at_8192(monkeypatch):
    """lbm_tpu's make_fused_program builds its x-tiled program at 8192^2,
    and the port's builds TemporalXtStep where the ping-pong pair does not
    fit (the row temporal kernel where it does)."""
    taken = []
    for name in ("build_multi_step_program", "build_temporal_program",
                 "build_temporal_xtiled_program", "build_fused_program"):
        monkeypatch.setattr(jfused, name, lambda *a, _n=name, **k: taken.append(_n))
    params = LBMParams(8192, 8192, 20000, 10, 0.1, 0.01, 1.85)
    obstacles = channel_box(8192, 8192)
    jfused.make_fused_program(_jax_params(params), obstacles, np.float32(1e-8),
                              max_iters=20000, device_kind="cpu")
    assert taken == ["build_temporal_xtiled_program"]
    prog = schedule.make_fused_program(params, obstacles, np.float32(1e-8), CPU,
                                       max_iters=20000, pingpong_fits=False)
    assert type(prog) is fused.TemporalXtStep and prog.chunk == 4
    pingpong = schedule.make_fused_program(params, obstacles, np.float32(1e-8), CPU,
                                           max_iters=20000)
    assert type(pingpong) is fused.TemporalStep and pingpong.n_buffers == 2
    # One f buffer and two band parities: below the ping-pong pair's 2 f.
    assert 1 + 2 * prog.band_floats / (9 * 8192 * 8192) <= 1.75


@pytest.mark.parametrize("max_iters", [8, 12], ids=["2-passes", "3-passes"])
def test_simulator_xtiled_branch_matches_lbm_tpu(max_iters, monkeypatch):
    """With the gate's widths lowered and no device memory for a ping-pong
    pair, a small grid takes the x-tiled branch: one f buffer, updated in
    place, against lbm_tpu's reference."""
    monkeypatch.setattr(runtime, "hbm_budget_gib", lambda device: 0.0)
    monkeypatch.setattr(schedule, "MULTISTEP_CELL_BUDGET", 0)
    monkeypatch.setattr(schedule, "XTILED_MIN_NX", 0)
    monkeypatch.setattr(schedule, "xtiled_strips", lambda nx: [2])
    params, obstacles, f0 = gate_case(32, 48, seed=70 + max_iters)
    params = dataclasses.replace(params, max_iters=max_iters)
    sim = Simulator(params, obstacles, device=CPU)
    prog = sim.program
    assert isinstance(prog, fused.TemporalXtStep)
    assert max_iters // prog.chunk == max_iters // 4
    ours = sim.run(f0=f0, readback="state")
    theirs = lbm_tpu.Simulator(_jax_params(params), obstacles, kernel="reference").run(
        f0=jnp.asarray(f0), readback="state")
    np.testing.assert_allclose(ours.f, np.asarray(theirs.f), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours.av_vels, theirs.av_vels, rtol=1e-4)
    assert ours.steps_per_pass == prog.chunk
    assert ours.bytes_per_update == fused.inplace_bytes_per_update(prog.by, prog.bx,
                                                                   prog.chunk)
    fields = sim.run(f0=f0, readback="fields")
    assert fields.fields.shape == (4, 32, 48)


@pytest.mark.parametrize("ping_pong_room", [True, False], ids=["pair-fits", "no-room"])
def test_giant_routing_follows_device_memory(ping_pong_room, monkeypatch):
    """A grid the gate admits (8192 wide) takes the row temporal kernel
    where the device holds a ping-pong pair of it, and the in-place x-tiled
    kernel (one f buffer, checkpoint hooks) where it holds only the in-place
    state: the choice follows ``hbm_budget_gib``, as the carry-resident
    checkpoint driver does."""
    ny, nx = 128, 8192
    f_gib = 9 * ny * nx * 4 / 2**30
    pair_gib = f_gib * (2 + 1 / 36)
    budget = pair_gib * (1.01 if ping_pong_room else 0.99)
    monkeypatch.setattr(runtime, "hbm_budget_gib", lambda device: budget)
    assert runtime.state_readback_fits(ny, nx, budget) == ping_pong_room
    params = LBMParams(nx, ny, 400, 10, 0.1, 0.01, 1.85)
    obstacles = channel_box(nx, ny)
    prog = make_program(params, obstacles, _fcinv(obstacles), "auto", CPU, max_iters=400)
    if ping_pong_room:
        assert type(prog) is fused.TemporalStep and prog.n_buffers == 2
    else:
        assert type(prog) is fused.TemporalXtStep and prog.n_buffers == 1
        assert prog.checkpoint_io is not None
        # The in-place state (f, both band parities, the mask) fits.
        inplace_gib = (f_gib + 2 * 4 * prog.band_floats / 2**30 + f_gib / 36)
        assert inplace_gib < budget
    assert (prog.by, prog.bx, prog.chunk) == schedule.choose_temporal(ny, nx, 400)


def test_mega_routing_is_lbm_tpus(tmp_path, monkeypatch, capsys):
    """kernel='mega': the temporal tile and K, then the largest T <= 25
    with T*K | max_iters; no split (no step count, or no T) falls back to
    the default schedule.  ``lbm run --kernel mega`` and ``bench --kernel
    mega`` run it."""
    params = LBMParams(64, 32, 40, 10, 0.1, 0.005, 1.85)
    obstacles = channel_box(64, 32)
    fcinv = _fcinv(obstacles)
    prog = make_program(params, obstacles, fcinv, "mega", CPU, max_iters=20000)
    by, bx, k = schedule.choose_temporal(32, 64, 20000)
    assert isinstance(prog, fused.MegaStep) and (prog.by, prog.bx, prog.ksteps) == (by, bx, k)
    assert prog.tpasses == 25 and prog.chunk == 100 and 20000 // prog.chunk == 200
    assert make_program(params, obstacles, fcinv, "mega", CPU, max_iters=40).tpasses == 10
    for max_iters in (None, 1001):  # no step count; no K dividing it
        fallback = make_program(params, obstacles, fcinv, "mega", CPU, max_iters=max_iters)
        default = make_program(params, obstacles, fcinv, "auto", CPU, max_iters=max_iters)
        assert not isinstance(fallback, fused.MegaStep)
        assert type(fallback) is type(default) and fallback.chunk == default.chunk

    monkeypatch.setenv("LBM_DEVICE", "cpu")
    params.to_file(tmp_path / "input.params")
    write_obstacle_file(tmp_path / "obstacles.dat", obstacles)
    for kernel in ("mega", "reference"):
        assert cli.main(["run", str(tmp_path / "input.params"),
                         str(tmp_path / "obstacles.dat"), "--kernel", kernel,
                         "--output-dir", str(tmp_path / kernel)]) == 0
    a = np.loadtxt(tmp_path / "mega" / "av_vels.dat", usecols=[1])
    b = np.loadtxt(tmp_path / "reference" / "av_vels.dat", usecols=[1])
    np.testing.assert_allclose(a, b, rtol=1e-4)
    assert cli.main(["bench", str(tmp_path / "input.params"),
                     str(tmp_path / "obstacles.dat"), "--kernel", "mega",
                     "--repeats", "1"]) == 0
    assert '"kernel": "mega"' in capsys.readouterr().out


def test_inplace_programs_never_take_the_plain_path_on_other_devices(monkeypatch):
    params, obstacles, f0 = gate_case(8, 12, seed=80)
    fcinv = _fcinv(obstacles)
    for prog in (fused.TemporalXtStep(params, obstacles, fcinv, CPU, 4, 4, 2),
                 fused.MegaStep(params, obstacles, fcinv, CPU, 4, 4, 2, 2)):

        def no_plain(*args, **kwargs):
            raise AssertionError("the CUDA path fell back to the plain version")

        monkeypatch.setattr(prog, "_plain_pass", no_plain)
        f = torch.empty(f0.shape, device="meta")
        carry = fused.BandCarry(f, torch.empty(2, prog.band_floats, device="meta"))
        av = torch.empty(4, device="meta")

        def failing_build():
            raise _build.BuildError("simulated build failure")

        monkeypatch.setattr(_build, "load_library", failing_build)
        with pytest.raises(_build.BuildError, match="simulated"):
            type(prog)(params, obstacles, fcinv, torch.device("cuda", 0), 4, 4, 2,
                       *((2,) if isinstance(prog, fused.MegaStep) else ()))
        launches = dict(fused.LAUNCHES)
        monkeypatch.setattr(_build, "load_library", lambda: object())
        with pytest.raises(ValueError, match="CUDA or CPU"):
            prog.bind_carry(carry, av)
        assert fused.LAUNCHES == launches


def test_inplace_bytes_per_update():
    # 32x64 tiles, K 4: a 40x72 window read (37 B a cell), the centre and
    # 8 band rows and 8 band columns of it written (36 B a cell), over
    # 32*64*4 updates.
    assert fused.inplace_bytes_per_update(32, 64, 4) == (
        40 * 72 * 37 + (2048 + 8 * 64 + 32 * 8) * 36) / 8192
    assert fused.inplace_bytes_per_update(32, 64, 4) > fused.window_bytes_per_update(
        32, 64, 4)

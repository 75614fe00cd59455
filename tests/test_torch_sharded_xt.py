"""The sharded x-tiled route of the port (``make_sharded_temporal_xt_run``,
``ShardTemporalXtStep``, ``GhostExchange``) on the CPU: its plain route
against ``lbm_tpu``'s interpret-mode sharded x-tiled runs and, bitwise,
against the port's single-device x-tiled program; the shard pass against
plain one-steps; the ghost exchange; the routing and its refusals
(``tests/test_sharded.py:465-531``); checkpointing; ``bench_sharded``.

On the CPU every shard runs its plain version (the band algorithm in
torch on the slab and its ghost rows); ``chip_smoke.py`` holds the CUDA
kernel against it on the card.  Tolerances: against ``lbm_tpu``'s Pallas
runs in interpret mode, those of ``tests/test_sharded.py:415-462`` (f rtol
1e-5 atol 1e-9, av rtol 5e-4); against the port's single-device x-tiled
program, f bitwise (every cell runs the same operations on the same
values) and av rtol 1e-5 (the shards' sums add in another order).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import lbm_tpu
from lbm_tpu.parallel import sharded as jax_sharded
from lbm_tpu_torch import runtime
from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.geometry import channel_box, free_cells_of
from lbm_tpu_torch.ops import _build, fused, schedule
from lbm_tpu_torch.ops.reference import init_cells
from lbm_tpu_torch.parallel import sharded
from lbm_tpu_torch.parallel.halo import GhostExchange, SlabLayout
from lbm_tpu_torch.parallel.mesh import default_mesh, default_mesh_2d
from lbm_tpu_torch.runtime import Simulator
from lbm_tpu_torch.testing import gate_case
from lbm_tpu_torch.tools import bench_sharded

CPU = torch.device("cpu")
PARAMS = LBMParams(64, 64, 12, 10, 0.1, 0.005, 1.85)
MESHES = [(1, None), (2, None), (4, None), (2, 1)]


@pytest.fixture(autouse=True)
def cpu_shards(monkeypatch):
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (conftest XLA_FLAGS)")
    return jax.devices()[:8]


def _mesh(py, px):
    return default_mesh(py) if px is None else default_mesh_2d(py, px)


def _mesh_id(m):
    return f"{m[0]}" if m[1] is None else f"{m[0]}x{m[1]}"


def _fcinv(obstacles):
    return np.float32(1.0) / np.float32(free_cells_of(obstacles))


def _walls():
    """lbm_tpu's case: walls on the kick row and across a tile edge."""
    return channel_box(PARAMS.nx, PARAMS.ny, interior_row=PARAMS.ny - 3, interior_col=33)


def _single_xt(params, obstacles, f0, by, bx, k):
    """The port's single-device x-tiled program, plain, over the run."""
    prog = fused.TemporalXtStep(params, obstacles, _fcinv(obstacles), CPU, by, bx, k)
    av = torch.empty(params.max_iters, dtype=torch.float32)
    carry = prog.init(torch.as_tensor(f0).clone())
    launch = prog.bind_carry(carry, av)
    for i in range(params.max_iters // prog.chunk):
        launch(i)
    return carry.f.numpy(), av.numpy()


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_plain_route_matches_lbm_tpu_and_single_device(eight_devices, mesh):
    """64x64 x 12 steps, BY 8, K 2, PX 2: the port's plain sharded x-tiled
    route against lbm_tpu's on the same mesh (Pallas in interpret mode),
    and bitwise against the port's single-device x-tiled program."""
    obstacles = _walls()
    fcinv = _fcinv(obstacles)
    jparams = lbm_tpu.LBMParams(**dataclasses.asdict(PARAMS))
    if mesh[1] is None:
        run = jax_sharded.make_sharded_temporal_run(
            jparams, obstacles, fcinv, jax_sharded.default_mesh(mesh[0]), by=8, ksteps=2,
            px=2, interpret=True)
        ours = sharded.make_sharded_temporal_run(PARAMS, obstacles, fcinv, _mesh(*mesh),
                                                 by=8, ksteps=2, px=2)
    else:
        run = jax_sharded.make_sharded_temporal_xt_run(
            jparams, obstacles, fcinv, jax_sharded.default_mesh_2d(*mesh), by=8, ksteps=2,
            px=2, interpret=True)
        ours = sharded.make_sharded_temporal_xt_run(PARAMS, obstacles, fcinv, _mesh(*mesh),
                                                    by=8, ksteps=2, px=2)
    assert isinstance(ours, sharded.ShardedXtProgram) and ours.chunk == 2
    assert ours.variant == "temporal"
    jf, javs = run(lbm_tpu.ops.reference.init_cells(jparams))
    f, av = ours(init_cells(PARAMS))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(av.numpy(), np.asarray(javs), rtol=5e-4)
    shard = ours.shards[0][0]
    sf, sav = _single_xt(PARAMS, obstacles, init_cells(PARAMS), 8, shard.bx, 2)
    np.testing.assert_array_equal(f.numpy(), sf)
    np.testing.assert_allclose(av.numpy(), sav, rtol=1e-5)


@pytest.mark.parametrize(
    "ny, nx, py, by, k, px",
    [
        (48, 40, 3, 2, 5, 2),   # K > BY: the ghost rows span three tile rows
        (8, 48, 4, 2, 2, 3),    # row ny-2 is the last shard's first row
        (32, 64, 1, 8, 3, 2),   # one shard: the ghosts are its own edges
    ],
    ids=["k-gt-by", "kick-on-edge", "one-shard"],
)
def test_sharded_xt_equals_single_device_from_a_gate_state(ny, nx, py, by, k, px):
    """Odd slabs from a seeded state that exercises the kick gate, 4 passes:
    f bitwise the single-device plain run's, av within 1e-5."""
    params, obstacles, f0 = gate_case(ny, nx, seed=ny + k)
    params = dataclasses.replace(params, max_iters=4 * k)
    prog = sharded.make_sharded_temporal_xt_run(params, obstacles, _fcinv(obstacles),
                                                default_mesh(py), by=by, ksteps=k, px=px)
    f, av = prog(f0)
    single = Simulator(params, obstacles, kernel="reference", device=CPU).run(f0=f0)
    np.testing.assert_array_equal(f.numpy(), single.f)
    np.testing.assert_allclose(av.numpy(), single.av_vels, rtol=1e-5)


@pytest.mark.parametrize("py, k", [(1, 2), (3, 2), (4, 4)], ids=["1", "3", "4-k4"])
def test_ghost_exchange_fills_the_neighbours_rows(py, k):
    """After one exchange each slab's ghost rows are the K global rows
    below and above it, with periodic wrap (one shard: its own edges)."""
    nyl, nx = 4, 6
    f = torch.from_numpy(np.random.default_rng(py).random((9, py * nyl, nx),
                                                           dtype=np.float32))
    layout = SlabLayout(nyl, nx, k)
    slabs = [(f[:, i * nyl:(i + 1) * nyl].clone(), torch.full(layout.ghost_shape, np.nan))
             for i in range(py)]
    GhostExchange(slabs, layout)()
    ny = py * nyl
    for i, (_, ghost) in enumerate(slabs):
        rows = np.r_[np.arange(i * nyl - k, i * nyl), np.arange((i + 1) * nyl,
                                                                (i + 1) * nyl + k)] % ny
        np.testing.assert_array_equal(ghost.numpy(), f[:, rows].numpy())
    assert layout.halo_bytes() == 2 * k * nx * 9 * 4
    mask = np.arange(ny * nx).reshape(ny, nx) % 3 != 0
    pad = layout.pad_mask(mask, nyl, 0)
    assert pad.dtype == np.uint8 and pad.shape == (nyl + 2 * k, nx)
    np.testing.assert_array_equal(pad, mask[(nyl - k + np.arange(nyl + 2 * k)) % ny])


def test_simulator_routes_explicit_splits_and_refuses():
    """lbm_tpu's routing and refusals (tests/test_sharded.py:465-531): an
    explicit (BY, K, PX) runs on a 1-D mesh and on a (2, 1) mesh; a mesh
    with two x shards refuses it; malformed tuples are refused."""
    obstacles = channel_box(PARAMS.nx, PARAMS.ny, interior_col=33)
    single = Simulator(PARAMS, obstacles, kernel="reference", device=CPU).run()
    for mesh in (default_mesh(2), default_mesh_2d(2, 1)):
        sim = sharded.ShardedSimulator(PARAMS, obstacles, mesh=mesh, kernel="temporal",
                                       temporal_split=(8, 2, 2))
        res = sim.run()
        assert sim.variant() == "temporal" and sim.chunk(12) == 2
        assert isinstance(sim.compiled().shards[0][0], fused.ShardTemporalXtStep)
        np.testing.assert_array_equal(res.f, single.f)
        np.testing.assert_allclose(res.av_vels, single.av_vels, rtol=1e-5)
    with pytest.raises(ValueError, match="x shard"):
        sharded.ShardedSimulator(PARAMS, obstacles, mesh=default_mesh_2d(2, 2),
                                 kernel="temporal", temporal_split=(8, 2, 2)).compiled()
    with pytest.raises(ValueError, match="BY, K"):
        sharded.ShardedSimulator(PARAMS, obstacles, mesh=default_mesh(2),
                                 kernel="temporal", temporal_split=(8,))
    with pytest.raises(ValueError, match="BY, K"):
        sharded.ShardedSimulator(PARAMS, obstacles, mesh=default_mesh(2),
                                 kernel="temporal", temporal_split=(8, 2, 2, 1))


@pytest.mark.parametrize(
    "mesh, split, match",
    [
        ((2, 1), (8, 2, 1), "px >= 2"),
        ((2, None), (8, 2, 3), "does not divide nx"),
        ((2, None), (12, 2, 2), "BY=12 does not divide"),
        ((2, None), (8, 5, 2), r"K \| max_iters"),
        ((8, None), (16, 2, 2), "BY=16 does not divide ny=8"),
        ((16, None), (4, 6, 2), "K <= nyl"),
    ],
    ids=["px-1", "px-nx", "by", "k", "by-nyl", "k-nyl"],
)
def test_xt_factory_refusals(mesh, split, match):
    """lbm_tpu's checks of the x-tiled split, and the one Hopper adds (the
    ghost rows come from one neighbour: K <= nyl)."""
    obstacles = channel_box(PARAMS.nx, PARAMS.ny)
    by, k, px = split
    with pytest.raises(ValueError, match=match):
        sharded.make_sharded_temporal_xt_run(PARAMS, obstacles, _fcinv(obstacles),
                                             _mesh(*mesh), by=by, ksteps=k, px=px)


@pytest.fixture()
def giant_xt(monkeypatch):
    """The x-tiled gate at small widths, and a card with no room for a
    ping-pong pair (the single-device tests' patch)."""
    monkeypatch.setattr(schedule, "XTILED_MIN_NX", 0)
    monkeypatch.setattr(schedule, "xtiled_strips", lambda nx: [2])


@pytest.mark.parametrize("mesh", [(2, None), (2, 1)], ids=_mesh_id)
def test_automatic_routing_follows_the_device_budget(giant_xt, monkeypatch, mesh):
    """Without a split, a slab takes the x-tiled route where lbm_tpu's gate
    admits it and the shards' ping-pong tiles do not fit the device
    (``hbm_budget_gib`` 0), as the single-device schedule does; else the
    shard temporal kernel keeps it."""
    obstacles = channel_box(PARAMS.nx, PARAMS.ny)
    fcinv = _fcinv(obstacles)
    factory = (sharded.make_sharded_temporal_run if mesh[1] is None
               else sharded.make_sharded_temporal_2d_run)
    kept = factory(PARAMS, obstacles, fcinv, _mesh(*mesh))
    assert isinstance(kept.shards[0][0], fused.ShardTemporalStep)
    monkeypatch.setattr(runtime, "hbm_budget_gib", lambda device: 0.0)
    xt = factory(PARAMS, obstacles, fcinv, _mesh(*mesh))
    first = xt.shards[0][0]
    assert isinstance(first, fused.ShardTemporalXtStep)
    assert (first.by, first.bx, first.ksteps) == schedule.choose_temporal_xtiled(
        32, 64, 12)
    # lbm_tpu's chains: "fused" tries the temporal factory first on a row
    # mesh; on a 2-D mesh without a split only "temporal" does.
    kernel = "fused" if mesh[1] is None else "temporal"
    sim = sharded.ShardedSimulator(PARAMS, obstacles, mesh=_mesh(*mesh), kernel=kernel)
    assert isinstance(sim.compiled().shards[0][0], fused.ShardTemporalXtStep)
    single = Simulator(PARAMS, obstacles, kernel="reference", device=CPU).run()
    np.testing.assert_array_equal(sim.run().f, single.f)


def test_checkpointed_run_resumes_bitwise(tmp_path):
    """A checkpointed x-tiled sharded run stopped at 8 steps and resumed to
    16 ends with the f and av of an uninterrupted one; a snapshot is f per
    shard, the bands rebuilt from it on resume."""
    params, obstacles, _ = gate_case(32, 64, seed=21)
    params = dataclasses.replace(params, max_iters=16)

    def sim():
        return sharded.ShardedSimulator(params, obstacles, mesh=default_mesh(2),
                                        kernel="temporal", temporal_split=(8, 2, 2))

    whole = sim().run_checkpointed(tmp_path / "a", every=4)
    sim().run_checkpointed(tmp_path / "b", every=4, max_iters=8)
    assert len(list((tmp_path / "b").glob("lbm_checkpoint.step8.shard.*.npz"))) == 2
    resumed = sim().run_checkpointed(tmp_path / "b", every=4)
    np.testing.assert_array_equal(resumed.f, whole.f)
    np.testing.assert_array_equal(resumed.av_vels, whole.av_vels)
    single = Simulator(params, obstacles, kernel="reference", device=CPU).run()
    np.testing.assert_array_equal(whole.f, single.f)


def test_shard_xt_program_never_takes_the_plain_path_on_other_devices(monkeypatch):
    """On a device that is not the CPU the shard x-tiled program launches its
    kernel or raises; a failed build raises where the program is made."""
    params, obstacles, _ = gate_case(16, 32, seed=80)
    fcinv = _fcinv(obstacles)
    layout = SlabLayout(8, 32, 2)
    mask = layout.pad_mask(~obstacles, 0, 0)
    prog = fused.ShardTemporalXtStep(params, mask, layout, 0, fcinv, CPU, 4, 16)

    def no_plain(*args, **kwargs):
        raise AssertionError("the CUDA path fell back to the plain version")

    monkeypatch.setattr(prog, "_plain_pass", no_plain)
    f = torch.empty(layout.shape, device="meta")
    ghost = torch.empty(layout.ghost_shape, device="meta")
    sums = torch.empty(2, device="meta")

    def failing_build():
        raise _build.BuildError("simulated build failure")

    monkeypatch.setattr(_build, "load_library", failing_build)
    with pytest.raises(_build.BuildError, match="simulated"):
        fused.ShardTemporalXtStep(params, mask, layout, 0, fcinv, torch.device("cuda", 0),
                                  4, 16)
    launches = dict(fused.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        prog.bind(f, ghost, sums)
    assert fused.LAUNCHES == launches


def test_bench_sharded_takes_the_three_part_split(capsys):
    assert bench_sharded.main(["--ny", "32", "--nx", "64", "--max-iters", "8",
                               "--shards", "2", "--kernel", "temporal",
                               "--temporal-split", "8x2x2", "--repeats", "1"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["shards"] == 2 and rec["kernel"] == "temporal" and rec["chunk"] == 2
    assert rec["halo_bytes_per_step_per_shard"] == SlabLayout(16, 64, 2).halo_bytes() / 2

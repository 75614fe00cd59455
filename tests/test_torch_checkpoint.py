"""Checkpoint/resume of the port: ``tests/test_checkpoint.py``'s single-device
cases against the port's ``Simulator.run_checkpointed`` and
``lbm_tpu_torch.checkpoint``, the carry-resident path of the x-tiled
program, a resume across the two packages in both directions, and the
sharded runs' per-shard snapshots (``save_sharded``), also across packages.

Segmented and resumed runs equal the uninterrupted run of the same program
bitwise: a segment boundary changes no arithmetic.  The x-tiled program
equals the plain one-step in f to the bit, but sums av in another order
(av rtol 1e-5 against the reference step).  Across packages the two step
functions differ in rounding (f atol 1e-6 and av rtol 1e-5, the measured gap of
``tests/test_torch_reference.py`` over tens of steps).  Across packages
the sharded runs sum av over shards in two more orders, and are held at
av rtol 1e-4, the port's tolerance of ``tests/test_torch_reference.py``.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbm_tpu
from lbm_tpu import checkpoint as jax_ckpt
from lbm_tpu_torch import checkpoint as ckpt
from lbm_tpu_torch import runtime
from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.geometry import channel_box, free_cells_of
from lbm_tpu_torch.ops import fused
from lbm_tpu_torch.ops.reference import init_cells
from lbm_tpu_torch.runtime import Simulator

PARAMS = LBMParams(64, 32, 30, 10, 0.1, 0.005, 1.85)
CPU = torch.device("cpu")
F_ATOL, AV_RTOL = 1e-6, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The grids here are small, and the suite runs in parallel workers:
    intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_sim(params=PARAMS, obstacles=None):
    if obstacles is None:
        obstacles = channel_box(params.nx, params.ny)
    return Simulator(params, obstacles, device=CPU)


def _jax_params(params):
    return lbm_tpu.LBMParams(**dataclasses.asdict(params))


def test_segmented_equals_continuous(tmp_path):
    cont = make_sim().run()
    seg = make_sim().run_checkpointed(tmp_path, every=7)
    np.testing.assert_array_equal(cont.f, seg.f)
    np.testing.assert_array_equal(cont.av_vels, seg.av_vels)
    assert ckpt.load(tmp_path).step == 30
    assert seg.steps_timed == 30 and seg.steps_per_pass >= 1


def test_resume_from_partial(tmp_path):
    """A crash after 2 segments, then a resume, equals the continuous run."""
    make_sim().run_checkpointed(tmp_path, every=8, max_iters=16)  # "crashes" at 16
    assert ckpt.load(tmp_path).step == 16
    res = make_sim().run_checkpointed(tmp_path, every=8)
    cont = make_sim().run()
    np.testing.assert_array_equal(cont.f, res.f)
    np.testing.assert_array_equal(cont.av_vels, res.av_vels)
    assert ckpt.load(tmp_path).step == 30


@pytest.mark.parametrize(
    "change, match",
    [({"obstacles": "interior_row"}, "mask"), ({"omega": 1.5}, "omega"),
     ({"accel": 0.01}, "accel"), ({"density": 0.2}, "density"), ({"nx": 128}, "grid")],
    ids=["mask", "omega", "accel", "density", "grid"],
)
def test_resume_rejects_another_run(tmp_path, change, match):
    """A snapshot of another case must not splice two trajectories."""
    make_sim().run_checkpointed(tmp_path, every=10, max_iters=10)
    if "obstacles" in change:
        other = make_sim(obstacles=channel_box(64, 32, interior_row=15))
    else:
        params = dataclasses.replace(PARAMS, **change)
        other = make_sim(params)
    with pytest.raises(ValueError, match=match):
        other.run_checkpointed(tmp_path, every=10)


def test_checkpoint_beyond_max_iters(tmp_path):
    make_sim().run_checkpointed(tmp_path, every=10, max_iters=20)
    with pytest.raises(ValueError, match="beyond"):
        make_sim().run_checkpointed(tmp_path, every=10, max_iters=10)
    with pytest.raises(ValueError, match="positive"):
        make_sim().run_checkpointed(tmp_path, every=0)


def test_load_missing_returns_none(tmp_path):
    assert ckpt.load(tmp_path) is None


def test_save_and_load_reject_short_av(tmp_path):
    """An av stream shorter than the committed step would shift later av
    rows off their timestep on resume: the writer and the reader refuse."""
    obs = channel_box(64, 32)
    f = np.zeros((9, 32, 64), np.float32)
    with pytest.raises(ValueError, match="av_vels has 5"):
        ckpt.save(tmp_path, PARAMS, obs, 10, f, np.zeros(5, np.float32))
    assert ckpt.load(tmp_path) is None
    header = json.dumps({"params": dataclasses.asdict(PARAMS), "step": 10,
                         "mask_digest": ckpt._mask_digest(obs), "version": 1})
    with open(tmp_path / ckpt.FILENAME, "wb") as fp:
        np.savez(fp, header=np.frombuffer(header.encode(), dtype=np.uint8), f=f,
                 av_vels=np.zeros(5, np.float32))
    with pytest.raises(ValueError, match="av stream has 5"):
        ckpt.load(tmp_path)


def test_v1_files_are_lbm_tpus(tmp_path):
    """Each package writes the same v1 header and arrays, and reads the
    other's file."""
    obs = channel_box(64, 32)
    rng = np.random.default_rng(3)
    f = rng.standard_normal((9, 32, 64)).astype(np.float32)
    av = rng.standard_normal(12).astype(np.float32)
    ckpt.save(tmp_path / "ours", PARAMS, obs, 12, f, av)
    jax_ckpt.save(tmp_path / "theirs", _jax_params(PARAMS), obs, 12, f, av)
    with (np.load(tmp_path / "ours" / ckpt.FILENAME) as x,
          np.load(tmp_path / "theirs" / jax_ckpt.FILENAME) as y):
        assert sorted(x.files) == sorted(y.files)
        for name in x.files:
            np.testing.assert_array_equal(x[name], y[name])
    theirs = ckpt.load(tmp_path / "theirs")
    ours = jax_ckpt.load(tmp_path / "ours")
    assert theirs.step == ours.step == 12
    np.testing.assert_array_equal(theirs.f, f)
    np.testing.assert_array_equal(ours.av_vels, av)
    theirs.validate(PARAMS, obs)


def test_v2_snapshot_and_precedence(tmp_path):
    """A sharded (v2) lbm_tpu snapshot loads on one device; with both
    layouts present the newer committed step wins, ties to v2."""
    obs = channel_box(64, 32)
    rng = np.random.default_rng(1)
    f8 = rng.standard_normal((9, 32, 64)).astype(np.float32)
    f16 = rng.standard_normal((9, 32, 64)).astype(np.float32)
    f8[4, 17, 3] = np.nan  # a diverged state still loads
    av16 = np.arange(16, dtype=np.float32)
    jparams = _jax_params(PARAMS)
    jax_ckpt.save_sharded(tmp_path, jparams, obs, 8, jnp.asarray(f8), av16[:8])
    loaded = ckpt.load(tmp_path)
    assert loaded.step == 8
    np.testing.assert_array_equal(loaded.f, f8)
    np.testing.assert_array_equal(loaded.av_vels, av16[:8])
    # A newer v1 beside the older v2 (a save that crashed before its prune).
    side = tmp_path / "side"
    ckpt.save(side, PARAMS, obs, 16, f16, av16)
    (tmp_path / ckpt.FILENAME).write_bytes((side / ckpt.FILENAME).read_bytes())
    assert ckpt.load(tmp_path).step == 16
    # An older v1 beside a newer v2.
    d2 = tmp_path / "v2newer"
    ckpt.save(d2, PARAMS, obs, 8, f8, av16[:8])
    v1 = (d2 / ckpt.FILENAME).read_bytes()
    jax_ckpt.save_sharded(d2, jparams, obs, 16, jnp.asarray(f16), av16)
    (d2 / ckpt.FILENAME).write_bytes(v1)
    loaded = ckpt.load(d2)
    assert loaded.step == 16
    np.testing.assert_array_equal(loaded.f, f16)
    # A newer av beside the committed meta is cut to the committed step; a
    # shorter one is refused.
    with open(d2 / ckpt.AV_FILENAME, "wb") as fp:
        np.savez(fp, av_vels=np.arange(24, dtype=np.float32))
    assert ckpt._load_sharded(d2).av_vels.shape == (16,)
    with open(d2 / ckpt.AV_FILENAME, "wb") as fp:
        np.savez(fp, av_vels=av16[:4])
    with pytest.raises(ValueError, match="av stream"):
        ckpt.load(d2)


def test_committed_save_prunes_stale_and_orphaned_files(tmp_path):
    """A v1 commit removes a stale v2 set and the ``*.tmp`` files of an
    earlier crashed save."""
    obs = channel_box(64, 32)
    f = np.zeros((9, 32, 64), np.float32)
    av = np.zeros(8, np.float32)
    jax_ckpt.save_sharded(tmp_path, _jax_params(PARAMS), obs, 4, jnp.asarray(f), av[:4])
    orphans = [tmp_path / "lbm_checkpoint.step4.shard0000.npz.tmp",
               tmp_path / (ckpt.AV_FILENAME + ".tmp"),
               tmp_path / (ckpt.META_FILENAME + ".tmp")]
    for p in orphans:
        p.write_bytes(b"crashed mid-write")
    ckpt.save(tmp_path, PARAMS, obs, 8, f, av)
    assert sorted(p.name for p in tmp_path.iterdir()) == [ckpt.FILENAME]
    assert ckpt.load(tmp_path).step == 8


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_crash_resume_cycles(tmp_path, seed):
    """Any sequence of crashes at random points resumes to the exact
    continuous trajectory."""
    rng = np.random.default_rng(seed)
    cont = make_sim().run()
    every = int(rng.integers(3, 12))
    progress = 0
    for _ in range(int(rng.integers(1, 4))):
        if progress >= 30:
            break
        stop = int(rng.integers(progress + 1, 31))
        make_sim().run_checkpointed(tmp_path, every=every, max_iters=stop)
        progress = stop
    res = make_sim().run_checkpointed(tmp_path, every=every)
    np.testing.assert_array_equal(cont.f, res.f)
    np.testing.assert_array_equal(cont.av_vels, res.av_vels)


def test_resume_reports_only_executed_steps(tmp_path):
    """A resumed run's rates must not credit the pre-crash steps to this
    invocation."""
    make_sim().run_checkpointed(tmp_path, every=10, max_iters=20)
    res = make_sim().run_checkpointed(tmp_path, every=10)
    assert res.params.max_iters == 30 and res.steps_timed == 10
    assert res.av_vels.shape == (30,)
    done = make_sim().run_checkpointed(tmp_path, every=10)  # nothing left
    assert done.steps_timed == 0 and done.mlups == 0
    np.testing.assert_array_equal(done.f, res.f)


# -- carry-resident checkpointing (giant grids) -------------------------------
#
# The real trigger is a grid whose state readback does not fit the device;
# here a zero budget and a small x-tiled program stand in for it.

XT_PARAMS = LBMParams(64, 16, 8, 10, 0.1, 0.01, 1.85)


@pytest.fixture()
def carry_setup(monkeypatch):
    obstacles = channel_box(64, 16, interior_row=9)
    fcinv = np.float32(1.0) / np.float32(free_cells_of(obstacles))
    programs = []

    def xtiled(params, obstacles, free_cells_inv, kernel, device, max_iters=None):
        programs.append(fused.TemporalXtStep(params, obstacles, free_cells_inv, device,
                                             4, 16, 2))
        return programs[-1]

    cont = Simulator(XT_PARAMS, obstacles, kernel="reference", device=CPU).run()
    monkeypatch.setattr(runtime, "hbm_budget_gib", lambda device: 0.0)
    monkeypatch.setattr(runtime, "make_program", xtiled)
    return obstacles, cont, programs


def test_carry_checkpoint_matches_reference(tmp_path, carry_setup):
    obstacles, cont, programs = carry_setup
    res = Simulator(XT_PARAMS, obstacles, device=CPU).run_checkpointed(tmp_path, every=4)
    assert res.steps_per_pass == 2 and len(programs) == 1  # the x-tiled chunk
    np.testing.assert_allclose(res.f, cont.f, rtol=0, atol=F_ATOL)
    np.testing.assert_allclose(res.av_vels, cont.av_vels, rtol=AV_RTOL)
    saved = ckpt.load(tmp_path)
    assert saved.step == 8 and saved.f.shape == (9, 16, 64)


def test_carry_checkpoint_resume_bitexact(tmp_path, carry_setup):
    """Crash after one segment, resume: the host f <-> carry round trip
    continues bit for bit; one program serves both calls."""
    obstacles, cont, programs = carry_setup
    sim = Simulator(XT_PARAMS, obstacles, device=CPU)
    sim.run_checkpointed(tmp_path, every=4, max_iters=4)  # "crash"
    assert ckpt.load(tmp_path).step == 4
    res = sim.run_checkpointed(tmp_path, every=4)
    assert res.steps_timed == 4 and len(programs) == 1
    whole = Simulator(XT_PARAMS, obstacles, device=CPU).run_checkpointed(
        tmp_path / "whole", every=4)
    np.testing.assert_array_equal(res.f, whole.f)
    np.testing.assert_array_equal(res.av_vels, whole.av_vels)
    np.testing.assert_allclose(res.f, cont.f, rtol=0, atol=F_ATOL)


def test_carry_checkpoint_rejects_misaligned_resume(tmp_path, carry_setup):
    """A snapshot at a step offset that is not K-aligned leaves a tail the
    K-step schedule cannot reach; the error names that cause."""
    obstacles, _, _ = carry_setup
    ckpt.save(tmp_path, XT_PARAMS, obstacles, 3, init_cells(XT_PARAMS).numpy(),
              np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="resuming a checkpoint"):
        Simulator(XT_PARAMS, obstacles, device=CPU).run_checkpointed(tmp_path, every=4)


# -- across the two packages --------------------------------------------------


def test_port_resumes_an_lbm_tpu_snapshot(tmp_path):
    obstacles = channel_box(64, 32)
    jparams = _jax_params(PARAMS)
    cont = lbm_tpu.Simulator(jparams, obstacles, kernel="reference").run()
    lbm_tpu.Simulator(jparams, obstacles, kernel="reference").run_checkpointed(
        str(tmp_path), every=8, max_iters=16)
    assert jax_ckpt.load(tmp_path).step == 16
    res = make_sim().run_checkpointed(tmp_path, every=8)
    assert res.steps_timed == 14
    np.testing.assert_allclose(res.f, np.asarray(cont.f), rtol=0, atol=F_ATOL)
    np.testing.assert_allclose(res.av_vels, cont.av_vels, rtol=AV_RTOL)
    np.testing.assert_array_equal(res.av_vels[:16], jax_ckpt.load(tmp_path).av_vels[:16])


def test_lbm_tpu_resumes_a_port_snapshot(tmp_path):
    obstacles = channel_box(64, 32)
    cont = make_sim().run()
    make_sim().run_checkpointed(tmp_path, every=8, max_iters=16)
    res = lbm_tpu.Simulator(_jax_params(PARAMS), obstacles,
                            kernel="reference").run_checkpointed(str(tmp_path), every=8)
    assert res.steps_timed == 14
    np.testing.assert_allclose(np.asarray(res.f), cont.f, rtol=0, atol=F_ATOL)
    np.testing.assert_allclose(res.av_vels, cont.av_vels, rtol=AV_RTOL)


# -- sharded (per-shard v2 snapshots) -----------------------------------------


def _sharded_sim(mesh, obstacles=None):
    from lbm_tpu_torch.parallel.sharded import ShardedSimulator

    if obstacles is None:
        obstacles = channel_box(PARAMS.nx, PARAMS.ny)
    return ShardedSimulator(PARAMS, obstacles, mesh=mesh, kernel="fused")


@pytest.fixture()
def cpu_meshes(monkeypatch):
    """(1-D mesh of 4 rows, 2x2 mesh), every shard on the CPU."""
    from lbm_tpu_torch.parallel.mesh import default_mesh, default_mesh_2d

    monkeypatch.setenv("LBM_DEVICE", "cpu")
    return default_mesh(4), default_mesh_2d(2, 2)


def test_save_sharded_round_trip(tmp_path, cpu_meshes):
    """Per-shard files named by their coordinates, the av stream and the
    meta as lbm_tpu writes them; load reassembles f; a later save prunes the
    earlier step's files and a v1 snapshot."""
    from lbm_tpu_torch.parallel.sharded import ShardedState

    obs = channel_box(64, 32)
    rng = np.random.default_rng(5)
    f = rng.standard_normal((9, 32, 64)).astype(np.float32)
    av = rng.standard_normal(10).astype(np.float32)
    tiles = [(y0, x0, torch.from_numpy(f[:, y0:y0 + 16, x0:x0 + 32]))
             for y0 in (0, 16) for x0 in (0, 32)]
    ckpt.save(tmp_path, PARAMS, obs, 4, f, av)
    ckpt.save_sharded(tmp_path, PARAMS, obs, 6, ShardedState(tiles, f.shape), av)
    meta = json.loads((tmp_path / ckpt.META_FILENAME).read_text())
    assert meta["version"] == 2 and meta["step"] == 6
    assert [e["file"] for e in meta["shards"]] == [
        f"lbm_checkpoint.step6.shard.y{y}.x{x}.npz" for y in (0, 16) for x in (0, 32)]
    assert meta["shards"][0]["shape"] == [9, 16, 32]
    loaded = ckpt.load(tmp_path)
    assert loaded.step == 6
    np.testing.assert_array_equal(loaded.f, f)
    np.testing.assert_array_equal(loaded.av_vels, av[:6])
    ckpt.save_sharded(tmp_path, PARAMS, obs, 8, f, av)  # one host array: one shard
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted([ckpt.AV_FILENAME, ckpt.META_FILENAME,
                            "lbm_checkpoint.step8.shard.y0.x0.npz"])
    jax_loaded = jax_ckpt.load(tmp_path)
    np.testing.assert_array_equal(jax_loaded.f, f)
    with pytest.raises(ValueError, match="av_vels has 10"):
        ckpt.save_sharded(tmp_path, PARAMS, obs, 12, f, av)


@pytest.mark.parametrize("which", [0, 1], ids=["rows", "2x2"])
def test_sharded_checkpointed_equals_uninterrupted(tmp_path, cpu_meshes, which):
    """Segmented, and stopped then resumed: bitwise the uninterrupted
    sharded run, and f bitwise the single-device run."""
    mesh = cpu_meshes[which]
    whole = _sharded_sim(mesh).run()
    seg = _sharded_sim(mesh).run_checkpointed(tmp_path / "a", every=8)
    np.testing.assert_array_equal(seg.f, whole.f)
    np.testing.assert_array_equal(seg.av_vels, whole.av_vels)
    assert seg.n_shards == 4 and seg.steps_timed == 30
    assert len(json.loads((tmp_path / "a" / ckpt.META_FILENAME).read_text())["shards"]) == 4
    _sharded_sim(mesh).run_checkpointed(tmp_path / "b", every=8, max_iters=16)
    res = _sharded_sim(mesh).run_checkpointed(tmp_path / "b", every=8)
    assert res.steps_timed == 14
    np.testing.assert_array_equal(res.f, whole.f)
    np.testing.assert_array_equal(res.av_vels, whole.av_vels)
    np.testing.assert_array_equal(res.f, make_sim().run().f)
    # A snapshot resumes on another mesh.
    other = _sharded_sim(cpu_meshes[1 - which]).run_checkpointed(tmp_path / "b", every=8,
                                                                 max_iters=30)
    assert other.steps_timed == 0
    np.testing.assert_array_equal(other.f, whole.f)


def test_port_resumes_an_lbm_tpu_sharded_snapshot(tmp_path, cpu_meshes):
    from lbm_tpu.parallel.sharded import ShardedSimulator as JaxSharded
    from lbm_tpu.parallel.sharded import default_mesh_2d as jax_mesh_2d

    obstacles = channel_box(64, 32)
    jparams = _jax_params(PARAMS)
    cont = JaxSharded(jparams, obstacles, mesh=jax_mesh_2d(2, 2)).run()
    JaxSharded(jparams, obstacles, mesh=jax_mesh_2d(2, 2)).run_checkpointed(
        str(tmp_path), every=8, max_iters=16)
    assert json.loads((tmp_path / ckpt.META_FILENAME).read_text())["step"] == 16
    res = _sharded_sim(cpu_meshes[0]).run_checkpointed(tmp_path, every=8)
    assert res.steps_timed == 14
    np.testing.assert_allclose(res.f, cont.f, rtol=0, atol=F_ATOL)
    np.testing.assert_allclose(res.av_vels, cont.av_vels, rtol=1e-4)
    np.testing.assert_array_equal(res.av_vels[:16], cont.av_vels[:16])


def test_lbm_tpu_resumes_a_port_sharded_snapshot(tmp_path, cpu_meshes):
    from lbm_tpu.parallel.sharded import ShardedSimulator as JaxSharded
    from lbm_tpu.parallel.sharded import default_mesh as jax_mesh

    obstacles = channel_box(64, 32)
    cont = _sharded_sim(cpu_meshes[1]).run()
    _sharded_sim(cpu_meshes[1]).run_checkpointed(tmp_path, every=8, max_iters=16)
    res = JaxSharded(_jax_params(PARAMS), obstacles, mesh=jax_mesh(4)).run_checkpointed(
        str(tmp_path), every=8)
    assert res.steps_timed == 14
    np.testing.assert_allclose(np.asarray(res.f), cont.f, rtol=0, atol=F_ATOL)
    np.testing.assert_allclose(res.av_vels, cont.av_vels, rtol=1e-4)

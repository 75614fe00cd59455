"""The port's host side against lbm_tpu's: config, geometry, writers and
the checker give the same values, the same bytes and the same verdicts."""

import dataclasses

import numpy as np
import pytest

import lbm_tpu.checker as jax_checker
import lbm_tpu.config as jax_config
import lbm_tpu.geometry as jax_geometry
import lbm_tpu.io as jax_io
from lbm_tpu_torch import checker, config, geometry, io

CASES = ("128x128", "128x256", "256x256", "1024x1024")


@pytest.fixture()
def pure_python_lbm_tpu(monkeypatch):
    """lbm_tpu on its pure-Python writers and parser (its optional CPython
    extension is not built here; the port's own native I/O is held against
    the pure-Python paths in test_torch_native_io.py)."""
    monkeypatch.setattr(jax_io, "_lbmio", None)
    monkeypatch.setattr(jax_geometry, "_lbmio", None)


def test_params_round_trip_and_parity(tmp_path):
    params = config.LBMParams(48, 32, 123, 10, 0.1, 0.0051, 1.7)
    params.to_file(tmp_path / "a.params")
    assert config.LBMParams.from_file(tmp_path / "a.params") == params
    theirs = jax_config.LBMParams.from_file(tmp_path / "a.params")
    assert dataclasses.asdict(theirs) == dataclasses.asdict(params)
    theirs.to_file(tmp_path / "b.params")
    assert (tmp_path / "a.params").read_bytes() == (tmp_path / "b.params").read_bytes()
    for case in CASES:
        assert dataclasses.asdict(config.CANONICAL_PARAMS[case]) == dataclasses.asdict(
            jax_config.CANONICAL_PARAMS[case]
        )
    with pytest.raises(ValueError):
        config.LBMParams(8, 1, 1, 10, 0.1, 0.005, 1.85)


@pytest.mark.parametrize("case", CASES)
def test_canonical_obstacles_equal(case):
    np.testing.assert_array_equal(
        geometry.canonical_obstacles(case), jax_geometry.canonical_obstacles(case)
    )


def test_obstacle_file_io_equal(tmp_path, pure_python_lbm_tpu):
    mask = np.random.default_rng(0).random((20, 30)) < 0.2
    geometry.write_obstacle_file(tmp_path / "a.dat", mask)
    jax_geometry.write_obstacle_file(tmp_path / "b.dat", mask)
    assert (tmp_path / "a.dat").read_bytes() == (tmp_path / "b.dat").read_bytes()
    ours, free = geometry.load_obstacle_file(tmp_path / "a.dat", 30, 20)
    theirs, their_free = jax_geometry.load_obstacle_file(tmp_path / "a.dat", 30, 20)
    np.testing.assert_array_equal(ours, mask)
    np.testing.assert_array_equal(ours, theirs)
    assert free == their_free == geometry.free_cells_of(mask)
    (tmp_path / "bad.dat").write_text("1 2 1\n40 2 1\n")
    with pytest.raises(ValueError, match="x-coord"):
        geometry.load_obstacle_file(tmp_path / "bad.dat", 30, 20)


def _state(ny=12, nx=16, seed=0):
    rng = np.random.default_rng(seed)
    params = config.LBMParams(nx, ny, 7, 10, 0.1, 0.005, 1.85)
    obstacles = geometry.channel_box(nx, ny)
    f = (0.1 / 9 * (1 + 0.05 * rng.standard_normal((9, ny, nx)))).astype(np.float32)
    return params, obstacles, f


def test_writers_byte_identical(tmp_path, pure_python_lbm_tpu):
    params, obstacles, f = _state()
    jparams = jax_config.LBMParams(**dataclasses.asdict(params))
    av = np.random.default_rng(1).random(7).astype(np.float32) * 1e-3

    io.write_av_vels(tmp_path / "av_ours.dat", av)
    jax_io.write_av_vels(tmp_path / "av_theirs.dat", av)
    assert (tmp_path / "av_ours.dat").read_bytes() == (tmp_path / "av_theirs.dat").read_bytes()
    np.testing.assert_allclose(io.read_av_vels(tmp_path / "av_ours.dat"), av, rtol=1e-12)

    io.write_final_state(tmp_path / "fs_ours.dat", params, f, obstacles)
    jax_io.write_final_state(tmp_path / "fs_theirs.dat", jparams, f, obstacles)
    assert (tmp_path / "fs_ours.dat").read_bytes() == (tmp_path / "fs_theirs.dat").read_bytes()

    fields = np.stack(io.final_state_columns(params, f, obstacles)).astype(np.float32)
    io.write_final_state(tmp_path / "ff_ours.dat", params, None, obstacles, fields=fields)
    jax_io.write_final_state(tmp_path / "ff_theirs.dat", jparams, None, obstacles,
                             fields=fields)
    assert (tmp_path / "ff_ours.dat").read_bytes() == (tmp_path / "ff_theirs.dat").read_bytes()
    np.testing.assert_array_equal(
        io.read_final_state(tmp_path / "fs_ours.dat"),
        jax_io.read_final_state(tmp_path / "fs_theirs.dat"),
    )
    with pytest.raises(ValueError, match="exactly one"):
        io.write_final_state(tmp_path / "x.dat", params, None, obstacles)


@pytest.mark.parametrize(
    "perturb, steps, with_fs",
    [(0.0, 7, True), (0.005, 7, True), (0.02, 7, True), (0.02, 7, False),
     (0.0, 6, False), (float("nan"), 7, False)],
    ids=["same", "0.5pct", "2pct", "2pct-av-only", "wrong-steps", "nan"],
)
def test_checker_verdicts_equal(tmp_path, perturb, steps, with_fs):
    params, obstacles, f = _state()
    av = np.linspace(1e-4, 2e-4, 7)
    io.write_av_vels(tmp_path / "ref_av.dat", av)
    io.write_final_state(tmp_path / "ref_fs.dat", params, f, obstacles)
    sim_av = av[:steps] * (1 + perturb)
    io.write_av_vels(tmp_path / "av.dat", sim_av)
    io.write_final_state(tmp_path / "fs.dat", params, f * (1 + abs(perturb) / 2), obstacles)
    kw = dict(
        ref_av_vels=str(tmp_path / "ref_av.dat"),
        av_vels=str(tmp_path / "av.dat"),
        ref_final_state=str(tmp_path / "ref_fs.dat") if with_fs else None,
        final_state=str(tmp_path / "fs.dat") if with_fs else None,
    )
    ours = checker.check_files(**kw)
    assert ours.ok == jax_checker.compare_files(**kw) == checker.compare_files(**kw)
    assert ours.ok == (steps == 7 and abs(perturb) <= 0.01)
    if steps == 7 and np.isfinite(perturb):
        assert abs(ours.worst_pct["av_vels"]) == pytest.approx(
            100 * perturb / (1 + perturb), rel=1e-6, abs=1e-9
        )
    assert checker.main(
        ["--ref-av-vels-file", kw["ref_av_vels"], "--av-vels-file", kw["av_vels"]]
    ) == jax_checker.main(
        ["--ref-av-vels-file", kw["ref_av_vels"], "--av-vels-file", kw["av_vels"]]
    )

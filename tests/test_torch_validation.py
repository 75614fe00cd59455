"""The port's float64 engine (lbm_tpu_torch.validation) against
lbm_tpu.validation's numpy engine, the scalar model and the goldens."""

import pathlib

import numpy as np
import pytest

from lbm_tpu.config import LBMParams as JaxParams
from lbm_tpu.validation import init_cells64 as jax_init_cells64
from lbm_tpu.validation import run64 as jax_run64
from lbm_tpu_torch import io
from lbm_tpu_torch.config import CANONICAL_PARAMS, LBMParams
from lbm_tpu_torch.geometry import canonical_obstacles, channel_box
from lbm_tpu_torch.utils.debugging import assert_mass_conserved
from lbm_tpu_torch.validation import init_cells64, run64
from tests import numpy_model

GOLDENS = pathlib.Path(__file__).resolve().parent / "goldens"
AV_RTOL = 1e-12


@pytest.mark.parametrize(
    "ny, nx, steps, accel, seeded_f0",
    [(16, 24, 300, 0.005, False), (37, 53, 200, 0.01, False), (24, 40, 150, 0.005, True)],
    ids=["16x24", "37x53-accel-0.01", "24x40-seeded-f0"],
)
def test_run64_matches_lbm_tpu(ny, nx, steps, accel, seeded_f0):
    """f bitwise (the same operations in the same order), av within 1e-12
    relative (numpy sums the fluid speeds pairwise, torch otherwise)."""
    rng = np.random.default_rng(ny * nx)
    obs = channel_box(nx, ny) | (rng.random((ny, nx)) < 0.1)
    params = LBMParams(nx, ny, steps, 10, 0.1, accel, 1.85)
    jparams = JaxParams(nx, ny, steps, 10, 0.1, accel, 1.85)
    f0 = None
    if seeded_f0:
        f0 = jax_init_cells64(jparams) * (1 + 0.05 * rng.standard_normal((9, ny, nx)))
    f_ref, av_ref = jax_run64(jparams, obs, f0=f0)
    f, av = run64(params, obs, f0=f0, device="cpu")
    np.testing.assert_array_equal(f.numpy().view(np.uint64), f_ref.view(np.uint64))
    np.testing.assert_allclose(av, av_ref, rtol=AV_RTOL, atol=0)


def test_init_cells64_matches_lbm_tpu():
    ours = init_cells64(LBMParams(8, 6, 1, 10, 0.1, 0.01, 1.85), "cpu").numpy()
    theirs = jax_init_cells64(JaxParams(8, 6, 1, 10, 0.1, 0.01, 1.85))
    np.testing.assert_array_equal(ours, theirs)


def test_run64_matches_scalar_model(monkeypatch):
    """As tests/test_validation.py holds lbm_tpu's engine; the device from
    LBM_DEVICE."""
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    tiny = LBMParams(16, 8, 10, 10, 0.1, 0.005, 1.85)
    obs = np.random.default_rng(0).random((tiny.ny, tiny.nx)) < 0.2
    f_vec, av_vec = run64(tiny, obs, max_iters=6)
    f_s = numpy_model.init_cells(tiny.ny, tiny.nx, 0.1)
    free = obs.size - obs.sum()
    for t in range(6):
        f_s, tot = numpy_model.step(f_s, obs, 0.1, 0.005, 1.85)
        np.testing.assert_allclose(av_vec[t], tot / free, rtol=1e-12)
    np.testing.assert_allclose(f_vec.numpy(), f_s, rtol=1e-12)


def test_mass_conserved_fp64():
    params = LBMParams(32, 32, 50, 10, 0.1, 0.0, 1.85)  # no body force
    f0 = init_cells64(params, "cpu").numpy()
    f, _ = run64(params, channel_box(32, 32), device="cpu")
    np.testing.assert_allclose(f.numpy().sum(), f0.sum(), rtol=1e-12)
    assert_mass_conserved(f0, f.numpy(), rtol=1e-12)


def test_run64_tracks_the_vendored_128x128_golden():
    """A prefix of the vendored fp64 series (made by lbm_tpu's numpy engine,
    written with 13 significant digits)."""
    steps = 150
    golden = io.read_av_vels(GOLDENS / "128x128.fp64gen_av_vels.dat")[:steps]
    _, av = run64(CANONICAL_PARAMS["128x128"], canonical_obstacles("128x128"),
                  max_iters=steps, device="cpu")
    np.testing.assert_allclose(av, golden, rtol=AV_RTOL, atol=0)


def test_256x256_final_state_golden():
    """The golden this port's fp64 engine wrote: the canonical coordinates
    and obstacle column, density/3 as pressure on the obstacles, u = 0
    there, finite."""
    path = GOLDENS / "256x256.fp64gen_final_state.dat"
    table = io.read_final_state(path)
    mask = canonical_obstacles("256x256")
    ys, xs = np.divmod(np.arange(mask.size), mask.shape[1])
    np.testing.assert_array_equal(table[:, 0], xs)
    np.testing.assert_array_equal(table[:, 1], ys)
    np.testing.assert_array_equal(table[:, 6], mask.ravel())
    assert np.isfinite(table).all()
    rows = path.read_text().splitlines()
    blocked = [rows[i].split() for i in np.flatnonzero(mask.ravel())]
    assert {r[5] for r in blocked} == {format(0.1 / 3, ".12E")}
    assert {r[2] for r in blocked} == {r[3] for r in blocked} == {format(0.0, ".12E")}

"""The port's profiling and debugging aids, as tests/test_utils.py holds
lbm_tpu's: PerfReport, assert_mass_conserved, nan_guard, and
interpret_kernels on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

import lbm_tpu.utils.debugging as jax_debugging
from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.geometry import channel_box
from lbm_tpu_torch.ops import fused
from lbm_tpu_torch.ops.lattice import CX, CY
from lbm_tpu_torch.ops.reference import init_cells
from lbm_tpu_torch.parallel.mesh import default_mesh
from lbm_tpu_torch.parallel.sharded import ShardedSimulator
from lbm_tpu_torch.runtime import Simulator
from lbm_tpu_torch.utils import debugging
from lbm_tpu_torch.utils.debugging import (
    assert_mass_conserved,
    interpret_kernels,
    nan_guard,
)
from lbm_tpu_torch.utils.profiling import BYTES_PER_CELL, PerfReport

PARAMS = LBMParams(32, 16, 5, 10, 0.1, 0.005, 1.85)


def test_perf_report_math():
    r = PerfReport(nx=1024, ny=1024, steps=20000, elapsed=2.0)
    assert r.cell_updates == 1024 * 1024 * 20000
    np.testing.assert_allclose(r.mlups, r.cell_updates / 2.0 / 1e6)
    np.testing.assert_allclose(
        r.effective_bandwidth_gbs, r.cell_updates * BYTES_PER_CELL / 2.0 / 1e9
    )


def test_perfreport_zero_elapsed_rates_are_inf():
    r = PerfReport(nx=64, ny=64, steps=10, elapsed=0.0)
    assert r.mlups == r.effective_bandwidth_gbs == float("inf")


def test_mass_conservation_guard():
    res = Simulator(PARAMS, channel_box(32, 16), kernel="reference", device="cpu").run()
    f0 = init_cells(PARAMS).numpy()
    assert_mass_conserved(f0, res.f, rtol=1e-4)
    with pytest.raises(AssertionError, match="mass") as ours:
        assert_mass_conserved(f0, res.f * 2.0)
    with pytest.raises(AssertionError) as theirs:
        jax_debugging.assert_mass_conserved(f0, res.f * 2.0)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(AssertionError, match="mass"):
        assert_mass_conserved(f0, np.full_like(res.f, np.nan))


def _poisoned_f0(params, y, x):
    """The uniform state with every population that streams into fluid cell
    (y, x) emptied: rho is 0 there after the first pull, and u 0/0."""
    f0 = init_cells(params).numpy().copy()
    for k in range(9):
        f0[k, y - CY[k], x - CX[k]] = 0.0
    return f0


@pytest.mark.parametrize("kernel", ["auto", "reference"])
def test_nan_guard_raises_on_the_first_bad_launch(kernel):
    params = dataclasses.replace(PARAMS, max_iters=8)
    sim = Simulator(params, channel_box(32, 16), kernel=kernel, device="cpu")
    f0 = _poisoned_f0(params, 5, 7)
    res = sim.run(f0=f0)  # no guard: the run ends with NaN
    assert not np.isfinite(res.f).all()
    with nan_guard():
        with pytest.raises(FloatingPointError, match="launch 0 left a non-finite value"):
            sim.run(f0=f0)
        clean = sim.run()  # a healthy run passes the guard
    np.testing.assert_array_equal(clean.f, sim.run().f)


def test_nan_guard_sharded(monkeypatch):
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    params = dataclasses.replace(PARAMS, max_iters=4)
    sim = ShardedSimulator(params, channel_box(32, 16), mesh=default_mesh(2))
    with nan_guard():
        sim.run()
        with pytest.raises(FloatingPointError, match="launch 0"):
            sim.run(f0=_poisoned_f0(params, 12, 20))


def test_scopes_are_explicit_and_restored():
    assert not debugging.interpreting()
    with pytest.raises(RuntimeError):
        with interpret_kernels():
            assert debugging.interpreting()
            raise RuntimeError
    assert not debugging.interpreting()
    meta = torch.empty(1, device="meta")
    assert not fused.runs_plain(meta) and fused.runs_plain(torch.empty(1))
    with interpret_kernels():
        assert fused.runs_plain(meta)
    guarded = debugging.guarded(print, lambda i: [("f", torch.tensor([np.nan]))])
    assert guarded is print  # no guard outside nan_guard(): the launch itself


def test_nan_guard_names_the_first_launch_that_made_a_nan():
    av = torch.zeros(6)

    def launch(i):
        av[2 * i:2 * i + 2] = np.inf if i >= 2 else 0.5

    with nan_guard():
        checked = debugging.guarded(launch, lambda i: [("av", av[2 * i:2 * i + 2])])
        checked(0)
        checked(1)
        with pytest.raises(FloatingPointError, match="launch 2 left a non-finite value in av"):
            checked(2)


@pytest.mark.parametrize("ny, nx, steps", [(64, 96, 8), (16, 24, 1009)],
                         ids=["temporal-or-multi", "one-step"])
def test_interpret_kernels_runs_the_plain_versions(ny, nx, steps):
    """On the CPU every program already runs its plain version: inside the
    scope the run is the same bits, with no kernel launched."""
    params = LBMParams(nx, ny, steps, 10, 0.1, 0.005, 1.85)
    sim = Simulator(params, channel_box(nx, ny), device="cpu")
    fused.reset_launches()
    outside = sim.run()
    with interpret_kernels():
        inside = sim.run()
    assert not any(fused.LAUNCHES.values())
    np.testing.assert_array_equal(outside.f, inside.f)
    np.testing.assert_array_equal(outside.av_vels, inside.av_vels)

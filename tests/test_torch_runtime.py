"""The port's Simulator against lbm_tpu's, the goldens, and its own rules:
ping-pong parity, state carried across from JAX, device selection, and no
silent fallback from the CUDA kernel.

Tolerances: f atol 1e-6 and av rtol 1e-4 as in test_torch_reference.py;
the fields payload is fp16: a value may round to the neighbouring fp16
(rtol 2**-10), and near u = 0 the f difference carried through u = m/rho
shows (measured 2.1e-6 at 128x128 x 400), so atol 1e-5.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbm_tpu
from lbm_tpu import checkpoint as jax_checkpoint
from lbm_tpu.ops.reference import make_step_fn
from lbm_tpu_torch import convert, runtime
from lbm_tpu_torch.config import CANONICAL_PARAMS
from lbm_tpu_torch.geometry import canonical_obstacles, free_cells_of
from lbm_tpu_torch.io import read_av_vels
from lbm_tpu_torch.ops import _build, fused
from lbm_tpu_torch.runtime import Simulator, select_device
from lbm_tpu_torch.testing import gate_case

F_ATOL, AV_RTOL, FIELDS_RTOL, FIELDS_ATOL = 1e-6, 1e-4, 2.0**-10, 1e-5
GOLDEN_128 = pathlib.Path(__file__).parent / "goldens" / "128x128.fp64gen_av_vels.dat"
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The grids here are small, and the suite runs in parallel workers:
    intra-op threads only contend (measured 3x slower at 128x128)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(params):
    return lbm_tpu.LBMParams(**dataclasses.asdict(params))


def test_fields_run_matches_lbm_tpu_and_golden_prefix():
    params = dataclasses.replace(CANONICAL_PARAMS["128x128"], max_iters=400)
    obstacles = canonical_obstacles("128x128")
    ours = Simulator(params, obstacles, device=CPU).run(readback="fields")
    theirs = lbm_tpu.Simulator(
        _jax_params(params), obstacles, kernel="reference"
    ).run(readback="fields")
    assert ours.f is None and ours.fields.shape == (4, 128, 128)
    np.testing.assert_allclose(ours.av_vels, theirs.av_vels, rtol=AV_RTOL)
    np.testing.assert_allclose(
        ours.fields, theirs.fields, rtol=FIELDS_RTOL, atol=FIELDS_ATOL
    )
    assert ours.reynolds == pytest.approx(theirs.reynolds, rel=1e-4)
    golden = read_av_vels(GOLDEN_128)[:400]
    assert np.abs((golden - ours.av_vels) / ours.av_vels).max() * 100 < 1.0
    assert ours.steps_timed == 400 and ours.elapsed > 0 and ours.mlups > 0


@pytest.mark.parametrize("steps", [0, 1, 4, 7])
def test_state_readback_ping_pong_parity(steps):
    params, obstacles, f0 = gate_case(16, 24, seed=steps)
    params = dataclasses.replace(params, max_iters=steps)
    fcinv = np.float32(1.0) / np.float32(free_cells_of(obstacles))
    jstep = jax.jit(make_step_fn(_jax_params(params), obstacles, fcinv))
    g, javs = jnp.asarray(f0), []
    for _ in range(steps):
        g, a = jstep(g)
        javs.append(float(a))
    sim = Simulator(params, obstacles, device=CPU)
    res = sim.run(f0=f0, readback="state")
    assert res.f.shape == (9, 16, 24) and res.av_vels.shape == (steps,)
    np.testing.assert_allclose(res.f, np.asarray(g), rtol=0, atol=F_ATOL)
    np.testing.assert_allclose(res.av_vels, javs, rtol=AV_RTOL)
    dev = sim.run(f0=torch.from_numpy(f0), readback="device")
    assert isinstance(dev.f, torch.Tensor)
    np.testing.assert_array_equal(dev.f.numpy(), res.f)


def test_default_start_is_the_uniform_state():
    params = dataclasses.replace(CANONICAL_PARAMS["128x128"], max_iters=3)
    sim = Simulator(params, canonical_obstacles("128x128"), device=CPU)
    np.testing.assert_array_equal(
        sim.run().f, sim.run(f0=sim.initial_state().numpy()).f
    )
    f1, av = sim.step_fn()(sim.initial_state())
    np.testing.assert_array_equal(f1.numpy(), sim.run(max_iters=1).f)
    with pytest.raises(ValueError, match="f0 must be"):
        sim.run(f0=np.zeros((9, 4, 4), np.float32))
    with pytest.raises(ValueError, match="readback"):
        sim.run(readback="nope")


def test_state_from_jax_continues_a_jax_run(tmp_path):
    """JAX 100 steps, then the port 100 more == JAX 200 steps; the state
    also round-trips lbm_tpu's v1 checkpoint f-format."""
    params, obstacles, f0 = gate_case(32, 48, seed=11)
    fcinv = np.float32(1.0) / np.float32(free_cells_of(obstacles))
    jstep = jax.jit(make_step_fn(_jax_params(params), obstacles, fcinv))
    g, javs = jnp.asarray(f0), []
    for _ in range(100):
        g, jav = jstep(g)
        javs.append(float(jav))
    f, fluid = convert.state_from_jax(np.asarray(g), obstacles, CPU)
    assert f.dtype == torch.float32 and f.is_contiguous() and f.shape == (9, 32, 48)
    assert fluid.dtype == torch.uint8
    np.testing.assert_array_equal(fluid.numpy(), (~obstacles).astype(np.uint8))
    sim = Simulator(dataclasses.replace(params, max_iters=100), obstacles, device=CPU)
    np.testing.assert_array_equal(sim.program.fluid.numpy(), fluid.numpy())
    res = sim.run(f0=f, readback="device")
    for _ in range(100):
        g, jav = jstep(g)
    ours = convert.state_to_numpy(res.f)
    assert ours.dtype == np.float32 and ours.shape == (9, 32, 48)
    np.testing.assert_allclose(ours, np.asarray(g), rtol=0, atol=F_ATOL)
    np.testing.assert_allclose(res.av_vels[-1], float(jav), rtol=AV_RTOL)

    jparams = _jax_params(params)
    av = np.concatenate([np.float32(javs), res.av_vels])
    jax_checkpoint.save(tmp_path, jparams, obstacles, 200, ours, av)
    loaded = jax_checkpoint.load(tmp_path)
    np.testing.assert_array_equal(loaded.f, ours)
    np.testing.assert_array_equal(loaded.av_vels, av)
    with pytest.raises(ValueError, match="must be"):
        convert.state_from_jax(ours[:, :-1], obstacles, CPU)


def test_select_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("LBM_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="LBM_DEVICE=cpu"):
        select_device()
    monkeypatch.setenv("LBM_DEVICE", "0")
    with pytest.raises(RuntimeError, match="no CUDA"):
        select_device()
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    assert select_device() == CPU
    assert select_device("CPU") == CPU
    params = dataclasses.replace(CANONICAL_PARAMS["128x128"], max_iters=1)
    assert Simulator(params, canonical_obstacles("128x128")).device == CPU


def test_auto_kernel_on_cuda_builds_the_kernel_or_raises(monkeypatch):
    """On a CUDA device 'auto' means the kernel: a failed build raises out
    of the constructor instead of running the plain version."""
    calls = []

    def failing_build():
        calls.append(1)
        raise _build.BuildError("simulated build failure")

    monkeypatch.setattr(_build, "load_library", failing_build)
    params = dataclasses.replace(CANONICAL_PARAMS["128x128"], max_iters=1)
    obstacles = canonical_obstacles("128x128")
    for kernel in ("auto", "fused"):
        with pytest.raises(_build.BuildError):
            Simulator(params, obstacles, kernel=kernel, device="cuda:0")
    assert len(calls) == 2
    sim = Simulator(params, obstacles, kernel="reference", device=CPU)
    assert isinstance(sim.program, fused.ReferenceStep)
    # The chosen program: one step has no chunk > 1, 40,000 steps do.
    assert isinstance(Simulator(params, obstacles, device=CPU).program, fused.FusedStep)
    sim = Simulator(dataclasses.replace(params, max_iters=40000), obstacles, device=CPU)
    assert isinstance(sim.program, fused.MultiStep) and sim.program.chunk == 200
    assert isinstance(sim.program_for(1009), fused.FusedStep)
    mega = Simulator(dataclasses.replace(params, max_iters=40000), obstacles,
                     kernel="mega", device=CPU)
    assert isinstance(mega.program, fused.MegaStep) and 40000 % mega.program.chunk == 0
    with pytest.raises(ValueError, match="unknown kernel"):
        Simulator(params, obstacles, kernel="nope", device=CPU)


def test_state_readback_budget():
    # Two f buffers plus the uint8 mask: 1024^2 needs ~0.0713 GiB.
    assert runtime.state_readback_fits(1024, 1024, budget_gib=0.072)
    assert not runtime.state_readback_fits(1024, 1024, budget_gib=0.07)
    budget = runtime.hbm_budget_gib(CPU)
    assert budget > 0.5
    assert runtime.state_readback_fits(1024, 1024, budget)

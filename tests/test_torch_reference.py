"""Each plain-torch op against its lbm_tpu.ops.reference counterpart.

Inputs come from ``lbm_tpu_torch.testing.gate_case``: perturbed
populations, obstacles in the body-force row ny-2, and columns where the
kick gate is false.  Data movement and the single-add kick are compared
bitwise; the collision sums in another order, so f is held to atol 1e-6
and av to rtol 1e-4 (measured on CPU at 32x48: 5.6e-8 and 2.0e-5 after
200 steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops import reference as jref
from lbm_tpu_torch.geometry import free_cells_of
from lbm_tpu_torch.ops import reference as tref
from lbm_tpu_torch.testing import gate_case

F_ATOL, AV_RTOL = 1e-6, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The grids here are small, and the suite runs in parallel workers:
    intra-op threads only contend (measured 3x slower at 128x128)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=[(32, 48, 0), (9, 13, 1)], ids=["32x48", "9x13"])
def case(request):
    return gate_case(*request.param)


def test_uniform_and_accel_weights_equal(case):
    params = case[0]
    np.testing.assert_array_equal(tref.uniform_weights(params), jref.uniform_weights(params))
    np.testing.assert_array_equal(tref.accel_weights(params), jref.accel_weights(params))
    np.testing.assert_array_equal(
        tref.init_cells(params).numpy(), np.asarray(jref.init_cells(params))
    )
    assert tref.init_cells(params).is_contiguous()


def test_accelerate_flow_bitwise_with_gate(case):
    params, obstacles, f0 = case
    w1, w2 = tref.accel_weights(params)
    row = params.ny - 2
    ours = tref.accelerate_flow(
        torch.from_numpy(f0), torch.from_numpy(obstacles[row]), w1, w2, row
    ).numpy()
    theirs = np.asarray(
        jref.accelerate_flow(jnp.asarray(f0), jnp.asarray(obstacles[row]), w1, w2, row)
    )
    np.testing.assert_array_equal(ours, theirs)
    # The case really exercises the gate: some columns kicked, and neither
    # the obstacle columns nor the starved ones.
    kicked = ours[1, row] != f0[1, row]
    assert 0 < kicked.sum() < params.nx
    assert not kicked[obstacles[row]].any()
    starved = (f0[3, row] - w1 <= 0) | (f0[6, row] - w2 <= 0) | (f0[7, row] - w2 <= 0)
    assert starved.any() and not kicked[starved].any()
    np.testing.assert_array_equal(np.delete(ours, row, axis=1), np.delete(f0, row, axis=1))


def test_stream_bitwise(case):
    f0 = case[2]
    np.testing.assert_array_equal(
        tref.stream(torch.from_numpy(f0)).numpy(), np.asarray(jref.stream(jnp.asarray(f0)))
    )


def test_collide_and_macroscopic(case):
    params, obstacles, f0 = case
    fluid = ~obstacles
    omega = np.float32(params.omega)
    ours, tot = tref.collide(torch.from_numpy(f0), torch.from_numpy(fluid), omega)
    theirs, jtot = jref.collide(jnp.asarray(f0), jnp.asarray(fluid), omega)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=F_ATOL)
    np.testing.assert_allclose(float(tot), float(jtot), rtol=AV_RTOL)
    # Bounce-back cells are a pure permutation.
    np.testing.assert_array_equal(
        ours.numpy()[:, obstacles], np.asarray(theirs)[:, obstacles]
    )
    for a, b in zip(tref.macroscopic(torch.from_numpy(f0)),
                    jref.macroscopic(jnp.asarray(f0))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)


def test_masked_step_200_steps(case):
    params, obstacles, f0 = case
    fcinv = np.float32(1.0) / np.float32(free_cells_of(obstacles))
    ours_step = tref.make_masked_step_fn(params, fcinv)
    theirs_step = jax.jit(jref.make_step_fn(params, obstacles, fcinv))
    fluid = torch.from_numpy(~obstacles)
    f, g = torch.from_numpy(f0), jnp.asarray(f0)
    for _ in range(200):
        f, av = ours_step(f, fluid)
        g, jav = theirs_step(g)
        np.testing.assert_allclose(float(av), float(jav), rtol=AV_RTOL)
    assert f.dtype == torch.float32
    np.testing.assert_allclose(f.numpy(), np.asarray(g), rtol=0, atol=F_ATOL)

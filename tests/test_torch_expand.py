"""The fields readback's reconstruction, ``runtime.expand_fields``:
``[u_x, u_y, rho - density]`` in float16 to ``[u_x, u_y, |u|, pressure]``
in float32, by numpy for a host payload and by ``lbm_expand_fields``
(``csrc/lbm_expand.cu``) for a payload on a card, to the same bits.

The input that matters is every float16 value: :func:`testing.fp16_sweep`
holds each bit pattern once in every plane, shuffled apart, so each value
meets many others in |u| and in the pressure, and inf and NaN appear where
numpy gives them (a NaN matches any NaN: its payload is not compared).
Tests marked for the card skip without one; they import no JAX, and run
there with ``python -m pytest tests/test_torch_expand.py --noconftest -k
card``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lbm_tpu_torch import runtime
from lbm_tpu_torch.config import CANONICAL_PARAMS
from lbm_tpu_torch.geometry import canonical_obstacles
from lbm_tpu_torch.testing import fp16_sweep, same_bits

DENSITIES = [0.1, 1.0 / 3.0]
SEED = 2900


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: lbm_expand_fields has no CPU mode")
    return torch.device("cuda", 0)


def _numpy(raw, obstacles, density):
    with np.errstate(all="ignore"):
        return runtime.expand_fields(np.asarray(raw), obstacles, density)


@pytest.mark.parametrize("density", DENSITIES)
def test_the_host_path_is_lbm_tpus_bits_on_every_fp16_value(density):
    from lbm_tpu import runtime as jax_runtime

    raw, obstacles = fp16_sweep(SEED)
    with np.errstate(all="ignore"):
        want = jax_runtime.expand_fields(raw, obstacles, density)
        got = runtime.expand_fields(raw, obstacles, density)
        from_tensor = runtime.expand_fields(torch.from_numpy(raw), obstacles, density)
    assert got.dtype == np.float32 and got.shape == (4, 256, 256)
    for out in (got, from_tensor):
        np.testing.assert_array_equal(out.view(np.int32), want.view(np.int32))
    # The sweep reaches inf and NaN in every plane, and both pressures.
    assert all(np.isnan(got[p]).any() and np.isinf(got[p]).any() for p in range(4))
    assert np.all(got[3][obstacles] == np.float32(density / 3.0))


@pytest.mark.parametrize("ny, nx, held, budget, rows", [
    (1024, 1024, 0, 2**30, 1024),                   # fits: the whole grid
    (1024, 1024, 2**30 - 16 * 2**20, 2**30, 1024),  # fits to the byte
    (1024, 1024, 2**30 - 16 * 2**20 + 1, 2**30, 1024),  # a slab holds it all
    (32768, 32768, 0, 0.0, 512),                    # slabs of 256 MiB
    (16, 1 << 25, 0, 0.0, 1),                       # a row past a slab: one a slab
])
def test_expand_rows_admits_the_whole_grid_where_it_fits(ny, nx, held, budget, rows):
    assert runtime.expand_rows(ny, nx, held, budget) == rows


@pytest.mark.parametrize("raw, obstacles", [
    (torch.zeros(3, 4, 8), np.zeros((4, 8), bool)),                    # float32
    (torch.zeros(2, 4, 8, dtype=torch.float16), np.zeros((4, 8), bool)),  # 2 planes
    (torch.zeros(3, 4, 8, dtype=torch.float16), np.zeros((8, 4), bool)),  # the mask
], ids=["dtype", "planes", "mask"])
def test_the_card_path_refuses_what_its_kernel_does_not_take(raw, obstacles):
    with pytest.raises(ValueError):
        runtime._expand_on_card(raw, obstacles, 0.1)


@pytest.mark.parametrize("density", DENSITIES)
def test_card_kernel_is_numpys_bits_on_every_fp16_value(density):
    dev = _card()
    raw, obstacles = fp16_sweep(SEED)
    got = runtime.expand_fields(torch.from_numpy(raw).to(dev), obstacles, density)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert same_bits(got, _numpy(raw, obstacles, density))


@pytest.mark.parametrize("rows", [1, 3, 64, 255])
@pytest.mark.parametrize("shape", [(256, 256), (37, 75)], ids=["256x256", "37x75"])
def test_card_slabs_are_the_whole_grids_bits(shape, rows):
    """Slabs of rows against the whole grid: at 256 wide every slab takes
    four cells a turn; at 75 wide, and after an odd row count, one."""
    dev = _card()
    raw, obstacles = fp16_sweep(SEED + rows)
    ny, nx = shape
    raw = np.ascontiguousarray(raw.reshape(3, -1)[:, :ny * nx].reshape(3, ny, nx))
    obstacles = np.ascontiguousarray(obstacles.reshape(-1)[:ny * nx].reshape(ny, nx))
    on_card = torch.from_numpy(raw).to(dev)
    whole = runtime._expand_on_card(on_card, obstacles, 0.1)
    slabs = runtime._expand_on_card(on_card, obstacles, 0.1, rows=rows)
    assert same_bits(slabs, whole)
    assert same_bits(whole, _numpy(raw, obstacles, 0.1))


def test_card_kernel_is_numpys_bits_on_a_real_run():
    """A 256^2 run's own payload, and the fields ``Simulator.run`` returns:
    the kernel's reconstruction inside the timer, numpy's on the payload."""
    dev = _card()
    params = dataclasses.replace(CANONICAL_PARAMS["256x256"], max_iters=2000)
    obstacles = canonical_obstacles("256x256")
    sim = runtime.Simulator(params, obstacles, device=dev)
    fields = sim.run(readback="fields").fields
    state = sim.run(readback="device").f
    raw = sim._fields(state, sim.program.fluid.bool())
    want = _numpy(raw.cpu().numpy(), obstacles, params.density)
    assert np.isfinite(want).all()
    assert same_bits(runtime.expand_fields(raw, obstacles, params.density), want)
    assert same_bits(fields, want)

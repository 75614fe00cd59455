"""The multi-step program (``MultiStep``) against lbm_tpu's
``_step_kernel_multi``, the buffer parity of its chunked launches, the
Simulator's multi-step branch, and its refusal to fall back.

The JAX side runs ``build_multi_step_program(..., interpret=True)`` as
``tests/test_fused.py`` does.  On the CPU ``MultiStep`` runs its plain
version (the band algorithm on the bands route, or ``chunk`` plain
one-steps on the grid route); the CUDA kernels are held against those plain
versions on the card by ``chip_smoke.py``.  Tolerances as in
test_torch_fused.py: f atol 1e-6, av rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbm_tpu
from lbm_tpu.ops.fused import build_multi_step_program
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


def test_plain_multi_step_matches_pallas_kernel():
    params, obstacles, f0, fcinv = _setup(16, 24, seed=21)
    program = build_multi_step_program(params, obstacles, fcinv, 8, interpret=True)
    jstep = jax.jit(program.step)
    carry = program.init(jnp.asarray(f0))
    ours = fused.MultiStep(params, obstacles, fcinv, CPU, chunk=8)
    assert ours.chunk == program.chunk == 8
    bufs = (torch.from_numpy(f0.copy()), torch.empty(f0.shape, dtype=torch.float32))
    av = torch.empty(16, dtype=torch.float32)
    launch = ours.bind(*bufs, av)
    launches = dict(fused.LAUNCHES)
    javs = []
    for i in range(2):
        carry, jav = jstep(carry)
        javs.append(np.asarray(jav))
        launch(i)
    np.testing.assert_allclose(av.numpy(), np.concatenate(javs), rtol=AV_RTOL)
    np.testing.assert_allclose(
        bufs[ours.final_index(2)].numpy(), np.asarray(program.final(carry)),
        rtol=0, atol=F_ATOL,
    )
    assert fused.LAUNCHES == launches  # the CPU path launches nothing


@pytest.mark.parametrize("ny, nx, chunk", [
    pytest.param(12, 20, 3, id="3"),
    pytest.param(12, 20, 4, id="4"),
    pytest.param(8, 640, 3, id="8x640-3"),  # rows wider than the bands kernel takes
    pytest.param(8, 640, 4, id="8x640-4"),
])
def test_chunked_launches_flip_once_per_step(ny, nx, chunk):
    """After n launches of ``chunk`` steps the state is where the
    grid-barrier kernel leaves it: ``bufs[(n * chunk) & 1]``, equal to
    n*chunk plain steps, and ``single`` advances one chunk.  (The bands
    route's parity: tests/test_torch_multi_bands.py.)"""
    params, obstacles, f0, fcinv = _setup(ny, nx, seed=22 + chunk)
    prog = fused.MultiStep(params, obstacles, fcinv, CPU, chunk=chunk, route="grid")
    f = torch.from_numpy(f0)
    ref, ref_av = f, []
    for _ in range(3 * chunk):
        ref, a = prog.plain(ref)
        ref_av.append(float(a))
    bufs = (f.clone(), torch.empty_like(f))
    av = torch.empty(3 * chunk, dtype=torch.float32)
    launch = prog.bind(*bufs, av)
    for i in range(3):
        launch(i)
    assert prog.final_index(3) == (3 * chunk) & 1
    np.testing.assert_array_equal(bufs[prog.final_index(3)].numpy(), ref.numpy())
    np.testing.assert_array_equal(av.numpy(), np.float32(ref_av))
    one, one_av = prog.single(f)
    assert one_av.shape == (chunk,)
    np.testing.assert_array_equal(one_av.numpy(), np.float32(ref_av[:chunk]))
    np.testing.assert_array_equal(f.numpy(), f0)  # single leaves f alone
    with pytest.raises(ValueError, match="out of range"):
        launch(3)


@pytest.mark.parametrize(
    "max_iters, chunk",
    [(512, 256), (768, 256), (771, 3)],
    ids=["2x256", "3x256", "257x3"],
)
def test_simulator_multi_branch_matches_lbm_tpu(max_iters, chunk):
    """The Simulator's multi-step branch at an even and an odd number of
    launches, and with an odd chunk (the state then ends in the second
    buffer), against lbm_tpu's reference."""
    params, obstacles, f0, _ = _setup(16, 24, seed=max_iters)
    params = dataclasses.replace(params, max_iters=max_iters)
    sim = Simulator(params, obstacles, device=CPU)
    assert isinstance(sim.program, fused.MultiStep) and sim.program.chunk == chunk
    ours = sim.run(f0=f0, readback="state")
    theirs = lbm_tpu.Simulator(_jax_params(params), obstacles, kernel="reference").run(
        f0=jnp.asarray(f0), readback="state"
    )
    np.testing.assert_allclose(ours.f, np.asarray(theirs.f), rtol=0, atol=F_ATOL)
    np.testing.assert_allclose(ours.av_vels, theirs.av_vels, rtol=AV_RTOL)
    assert ours.steps_per_pass == chunk
    assert ours.bytes_per_update == schedule.BYTES_PER_CELL / chunk


def test_multi_step_never_takes_the_plain_path_on_other_devices(monkeypatch):
    params, obstacles, f0, fcinv = _setup(8, 12, seed=40)
    prog = fused.MultiStep(params, obstacles, fcinv, CPU, chunk=4)

    def no_plain(*args, **kwargs):
        raise AssertionError("the CUDA path fell back to the plain version")

    monkeypatch.setattr(prog, "_plain_into", no_plain)
    monkeypatch.setattr(prog, "plain", no_plain)
    f = torch.empty(f0.shape, device="meta")
    av = torch.empty(4, device="meta")

    def failing_build():
        raise _build.BuildError("simulated build failure")

    monkeypatch.setattr(_build, "load_library", failing_build)
    with pytest.raises(_build.BuildError, match="simulated"):
        prog.bind(f, torch.empty_like(f), av)
    with pytest.raises(_build.BuildError, match="simulated"):
        fused.MultiStep(params, obstacles, fcinv, torch.device("cuda", 0), chunk=4)
    launches = dict(fused.LAUNCHES)
    monkeypatch.setattr(_build, "load_library", lambda: object())
    with pytest.raises(ValueError, match="CUDA or CPU"):
        prog.bind(f, torch.empty_like(f), av)
    assert fused.LAUNCHES == launches
    with pytest.raises(ValueError, match="chunk"):
        fused.MultiStep(params, obstacles, fcinv, CPU, chunk=0)

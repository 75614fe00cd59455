"""The multi-step kernel in one thread-block cluster: its plan (bands and
footprint), its route, its plain version (the band algorithm of
``csrc/lbm_multi_cluster.cu`` in torch) against plain one-steps and against
lbm_tpu's ``_step_kernel_multi``, and the buffer parity of its launches.

The JAX side runs ``build_multi_step_program(..., interpret=True)`` as
``tests/test_torch_multi.py`` does.  The CUDA kernel is held against the
plain version on the card by ``chip_smoke.py``.  Tolerances: f bitwise and
av within 1e-6 relative against plain one-steps (the same per-cell
operations; |u| summed in another order); f atol 1e-6 and av rtol 1e-4
against lbm_tpu, as in test_torch_multi.py.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops.fused import build_multi_step_program
from lbm_tpu_torch.geometry import free_cells_of
from lbm_tpu_torch.ops import _build, fused, schedule
from lbm_tpu_torch.testing import gate_case

F_ATOL, AV_RTOL, AV_RTOL_STEPS = 1e-6, 1e-4, 1e-6
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


def _one_steps(prog, f, steps):
    avs = []
    for _ in range(steps):
        f, a = prog.plain(f)
        avs.append(a)
    return f, torch.stack(avs)


@pytest.mark.parametrize("ny, nx, rows, smem", [
    (128, 128, 8, 36 * 128 * 14 + 10 * 128),
    (256, 128, 16, 36 * 128 * 22 + 18 * 128),
    (256, 256, 16, 36 * 256 * 22 + 18 * 256),
], ids=["128x128", "128x256", "256x256"])
def test_small_canonical_grids_fit_sixteen_blocks(ny, nx, rows, smem):
    c, bands, got = schedule.cluster_plan(ny, nx, 16)
    assert c == 16 and got == smem <= schedule.CLUSTER_SMEM_BUDGET
    assert bands == [(r * rows, rows) for r in range(16)]


@pytest.mark.parametrize("ny, nx, max_cluster, route", [
    (512, 512, 16, "grid"), (384, 384, 16, "grid"), (256, 256, 8, "bands"),
    (16, 1025, 16, "grid"), (64, 64, 0, "bands"),
], ids=["512x512", "384x384", "256x256-on-8", "wider-than-a-block", "no-cluster"])
def test_grids_beyond_the_cluster_have_no_plan(ny, nx, max_cluster, route):
    """No cluster plan, so never the cluster route: the bands kernel where
    its bands are one chunk on 132 SMs, else the grid kernel."""
    assert schedule.cluster_plan(ny, nx, max_cluster) is None
    assert schedule.multi_route(ny, nx, max_cluster, 132) == route


def test_uneven_bands_cover_the_grid_in_order():
    """37 rows over 16 blocks: the first 37 % 16 bands hold 3 rows, the
    rest 2, each band starting where the last ended."""
    c, bands, _ = schedule.cluster_plan(37, 75, 16)
    assert c == 16
    assert [rows for _, rows in bands] == [3] * 5 + [2] * 11
    assert [row0 for row0, _ in bands] == list(np.cumsum([0] + [r for _, r in bands][:-1]))


@pytest.mark.parametrize("ny", [2, 3, 10, 15])
def test_a_grid_of_fewer_rows_takes_fewer_blocks(ny):
    c, bands, _ = schedule.cluster_plan(ny, 24, 16)
    assert c == ny and bands == [(r, 1) for r in range(ny)]


def test_smem_formula_and_budget_are_the_kernels():
    src = (_build.SOURCES[0].parent / "lbm_multi_cluster.cu").read_text()
    body = re.search(r"long long smem_bytes\(.*?\{(.*?)\n\}", src, re.S).group(1)
    assert "const long long hmax = (ny + c - 1) / c;" in body
    assert ("9LL * nx * static_cast<long long>(sizeof(float)) * (hmax + 6) + (hmax + 2) * nx"
            in body)
    assert "nx < 1 || nx > kThreads" in body
    assert "constexpr int kSmemBudget = 232448 - 1024;" in src
    assert "constexpr int kThreads = 1024;" in src
    assert "constexpr int kMaxCluster = 16;" in src
    assert schedule.CLUSTER_SMEM_BUDGET == 232_448 - 1024
    assert (schedule.CLUSTER_THREADS, schedule.CLUSTER_MAX) == (1024, 16)
    assert any(p.name == "lbm_multi_cluster.cu" for p in _build.SOURCES)


@pytest.mark.parametrize("admission, ny, nx, route, cluster", [
    ((16, 7), 128, 128, "cluster", 16),
    ((16, 7), 256, 128, "grid", 0),   # two chunks a band: the grid kernel is faster
    ((16, 7), 256, 256, "grid", 0),
    ((16, 7), 37, 75, "cluster", 16),
    ((8, 3), 128, 128, "grid", 0),    # 16-row bands on 8 blocks: two chunks
    ((8, 3), 64, 96, "cluster", 8),
    ((0, 0), 64, 96, "grid", 0),
], ids=["16-128x128", "16-128x256", "16-256x256", "16-37x75", "8-128x128", "8-64x96",
        "none"])
def test_route_follows_the_cards_admission(admission, ny, nx, route, cluster, monkeypatch):
    """The route is decided when the program is made, from the admission
    query (stubbed here, with no SMs for the bands kernel, whose route
    would come first: tests/test_torch_multi_bands.py) and the footprint;
    ``route=`` forces one."""
    monkeypatch.setattr(schedule, "cluster_admission", lambda device: admission)
    monkeypatch.setattr(schedule, "bands_admission", lambda device: 0)
    params, obstacles, _, fcinv = _setup(ny, nx, seed=7)
    prog = fused.MultiStep(params, obstacles, fcinv, CPU, chunk=4)
    assert (prog.route, prog.cluster) == (route, cluster)
    assert prog.route == schedule.multi_route(ny, nx, admission[0], 0)
    assert fused.MultiStep(params, obstacles, fcinv, CPU, chunk=4, route="grid").route == "grid"
    if schedule.cluster_plan(ny, nx, admission[0]) is None:
        with pytest.raises(ValueError, match="does not fit a cluster"):
            fused.MultiStep(params, obstacles, fcinv, CPU, chunk=4, route="cluster")
    else:
        forced = fused.MultiStep(params, obstacles, fcinv, CPU, chunk=4, route="cluster")
        assert forced.route == "cluster" and forced.cluster == min(admission[0], ny)
    with pytest.raises(ValueError, match="route"):
        fused.MultiStep(params, obstacles, fcinv, CPU, chunk=4, route="persistent")


def test_the_card_is_asked_once_per_device(monkeypatch):
    """``cluster_admission`` takes the largest size the card runs at a
    full block of shared memory, asks once per device, and raises on a
    failed query."""
    calls = []

    class FakeLib:
        def lbm_multi_cluster_active(self, device, c, smem):
            calls.append((device, c, smem))
            return {16: 0, 8: 3}.get(c, 5) if device == 3 else -1

        def lbm_error_string(self, code):
            return b"invalid device"

    monkeypatch.setattr(_build, "load_library", FakeLib)
    schedule._card_cluster.cache_clear()
    try:
        assert schedule.cluster_admission(torch.device("cuda", 3)) == (8, 3)
        assert schedule.cluster_admission(torch.device("cuda", 3)) == (8, 3)
        budget = schedule.CLUSTER_SMEM_BUDGET
        assert calls == [(3, 16, budget), (3, 8, budget)]
        with pytest.raises(RuntimeError, match="invalid device"):
            schedule.cluster_admission(torch.device("cuda", 4))
        assert schedule.cluster_admission(CPU) == (16, 0)
    finally:
        schedule._card_cluster.cache_clear()


@pytest.mark.parametrize("ny, nx, threads, steps, kick_at_edge", [
    (16, 24, 1024, 6, True),   # 1-row bands; row ny-2 is band 14, its neighbours' ghost
    (20, 24, 1024, 6, True),   # 2- and 1-row bands; row ny-2 a 1-row band
    (37, 75, 1024, 5, True),   # 3- and 2-row bands; row ny-2 the last band's first row
    (40, 24, 64, 5, True),     # two chunks a band: the saved row
    (64, 96, 128, 4, False),   # four 1-row chunks a band; row ny-2 inside one
    (24, 520, 1024, 3, True),  # one row a chunk at the kernel's own width
    (3, 8, 32, 7, True),       # three 1-row bands, each its neighbours' both ghosts
], ids=["1-row-bands", "mixed-bands", "37x75", "two-chunks", "four-chunks", "wide",
        "three-rows"])
def test_band_algorithm_is_bitwise_plain_one_steps(ny, nx, threads, steps, kick_at_edge):
    """The plain cluster algorithm (one copy of f in place, ghost rows in
    two parities, chunks with a saved row) gives the bits of ``steps``
    plain one-steps, at band edges, 1-row bands, row ny-2 on a band edge
    and in a ghost row; av within AV_RTOL_STEPS (another summation
    order)."""
    params, obstacles, f0, fcinv = _setup(ny, nx, seed=ny + nx)
    prog = fused.MultiStep(params, obstacles, fcinv, CPU, chunk=1, route="grid")
    c = min(schedule.CLUSTER_MAX, ny)
    bands = schedule.cluster_bands(ny, c)
    assert kick_at_edge == any(ny - 2 in (row0, row0 + rows - 1) for row0, rows in bands)
    sweep = fused.cluster_sweep(ny, nx, bands, threads, CPU)
    f = torch.from_numpy(f0)
    got, av = fused.cluster_steps(f, prog.fluid.bool(), params, float(fcinv), sweep, steps)
    ref, ref_av = _one_steps(prog, f, steps)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    np.testing.assert_allclose(av.numpy(), ref_av.numpy(), rtol=AV_RTOL_STEPS)
    np.testing.assert_array_equal(f.numpy(), f0)  # the input is left alone


def test_band_sums_follow_the_kernels_tree():
    """|u| of one step, summed as the kernel does (lanes over their cells,
    the warp tree, the tree over 32 warps, bands in order), reproduced
    here from the per-cell speeds of the plain step."""
    from lbm_tpu_torch.ops.reference import accelerate_flow, macroscopic, stream

    ny, nx = 40, 24
    params, obstacles, f0, fcinv = _setup(ny, nx, seed=5)
    prog = fused.MultiStep(params, obstacles, fcinv, CPU, chunk=1, route="grid")
    bands = schedule.cluster_bands(ny, 16)
    sweep = fused.cluster_sweep(ny, nx, bands, 64, CPU)
    f = torch.from_numpy(f0)
    _, av = fused.cluster_steps(f, prog.fluid.bool(), params, float(fcinv), sweep, 1)
    fluid = prog.fluid.bool()
    w1, w2 = fused.accel_weights(params)
    _, rho_inv, mx, my = macroscopic(stream(accelerate_flow(f, ~fluid[ny - 2], w1, w2,
                                                            ny - 2)))
    speed = torch.where(fluid, torch.sqrt(mx * mx + my * my) * rho_inv, 0.0)
    total = np.float32(0.0)
    for row0, rows in bands:
        lanes = np.zeros(64, dtype=np.float32)
        for j in range(-(-rows // 2)):  # 64 threads: 2 rows of 24 a chunk
            cells = speed[row0 + 2 * j:row0 + min(rows, 2 * j + 2)].reshape(-1).numpy()
            lanes[:cells.size] += cells
        warps = lanes.reshape(2, 32)
        for off in (16, 8, 4, 2, 1):
            warps = warps[:, :off] + warps[:, off:2 * off]
        w = np.concatenate([warps[:, 0], np.zeros(30, dtype=np.float32)])
        for off in (16, 8, 4, 2, 1):
            w = w[:off] + w[off:2 * off]
        total = np.float32(total + w[0])
    assert av.numpy()[0] == np.float32(total * np.float32(fcinv))


def test_plain_cluster_route_matches_pallas_kernel():
    ny, nx, chunk = 20, 32, 8
    params, obstacles, f0, fcinv = _setup(ny, nx, seed=31)
    program = build_multi_step_program(params, obstacles, fcinv, chunk, interpret=True)
    jstep = jax.jit(program.step)
    carry = program.init(jnp.asarray(f0))
    ours = fused.MultiStep(params, obstacles, fcinv, CPU, chunk=chunk, route="cluster")
    assert ours.route == "cluster" and ours.cluster == 16
    bufs = (torch.from_numpy(f0.copy()), torch.empty(f0.shape, dtype=torch.float32))
    av = torch.empty(2 * chunk, dtype=torch.float32)
    launch = ours.bind(*bufs, av)
    launches = dict(fused.LAUNCHES)
    javs = []
    for i in range(2):
        carry, jav = jstep(carry)
        javs.append(np.asarray(jav))
        launch(i)
    np.testing.assert_allclose(av.numpy(), np.concatenate(javs), rtol=AV_RTOL)
    np.testing.assert_allclose(bufs[ours.final_index(2)].numpy(),
                               np.asarray(program.final(carry)), rtol=0, atol=F_ATOL)
    assert fused.LAUNCHES == launches  # the CPU path launches nothing


@pytest.mark.parametrize("chunk", [3, 4], ids=["odd", "even"])
def test_cluster_launches_keep_the_buffer_parity(chunk):
    """Launch i reads ``bufs[(i * chunk) & 1]`` and leaves the state in
    ``bufs[((i + 1) * chunk) & 1]``, where the grid-barrier kernel leaves
    it: for an even chunk the buffer it read, the other one untouched."""
    params, obstacles, f0, fcinv = _setup(18, 20, seed=40 + chunk)
    prog = fused.MultiStep(params, obstacles, fcinv, CPU, chunk=chunk, route="cluster")
    assert prog.route == "cluster"
    f = torch.from_numpy(f0)
    ref, ref_av = _one_steps(prog, f, 3 * chunk)
    bufs = (f.clone(), torch.full_like(f, float("nan")))
    av = torch.empty(3 * chunk, dtype=torch.float32)
    launch = prog.bind(*bufs, av)
    for i in range(3):
        launch(i)
        state = bufs[prog.final_index(i + 1)]
        assert prog.final_index(i + 1) == ((i + 1) * chunk) & 1
        assert bool(state.isfinite().all())
    if chunk % 2 == 0:
        assert bool(bufs[1].isnan().all())
    np.testing.assert_array_equal(bufs[prog.final_index(3)].numpy(), ref.numpy())
    np.testing.assert_allclose(av.numpy(), ref_av.numpy(), rtol=AV_RTOL_STEPS)
    one, one_av = prog.single(f)
    np.testing.assert_array_equal(one_av.numpy(), av[:chunk].numpy())
    np.testing.assert_array_equal(f.numpy(), f0)
    with pytest.raises(ValueError, match="out of range"):
        launch(3)

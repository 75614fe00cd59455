"""The multi-step kernel across the card in bands of rows
(``csrc/lbm_multi_bands.cu``): its plan (blocks, bands, threads and
footprint), its route, its plain version (the band algorithm at its bands
and threads) against plain one-steps and against lbm_tpu's
``_step_kernel_multi``, and the buffer parity of its launches.

The JAX side runs ``build_multi_step_program(..., interpret=True)`` as
``tests/test_torch_multi.py`` does.  The CUDA kernel is held against the
plain version on the card by ``chip_smoke.py`` phase 3.  Tolerances: f
bitwise and av within 1e-6 relative against plain one-steps (the same
per-cell operations; |u| summed in another order); f atol 1e-6 and av rtol
1e-4 against lbm_tpu, as in test_torch_multi.py.
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


@pytest.mark.parametrize("ny, nx, blocks, rows, threads", [
    (128, 128, 128, 1, 128),
    (256, 128, 128, 2, 256),
    (256, 256, 128, 2, 512),
], ids=["128x128", "128x256", "256x256"])
def test_small_canonical_grids_take_one_block_an_sm(ny, nx, blocks, rows, threads):
    """On 132 SMs: the thinnest bands (1 or 2 rows), on the fewest blocks
    that give them, one cell a thread, one chunk a band, in the one-chunk
    step's two copies of a band and its ghost rows, and their mask."""
    g, bands, t, smem = schedule.bands_plan(ny, nx, 132)
    assert (g, t) == (blocks, threads)
    assert bands == [(r * rows, rows) for r in range(blocks)]
    assert smem == 73 * nx * (rows + 2) <= schedule.BANDS_SMEM_BUDGET
    assert schedule.bands_chunks(ny, nx, g) == 1


@pytest.mark.parametrize("ny, nx, max_blocks, width, chunks", [
    (128, 128, 132, 128, 1),
    (256, 128, 132, 128, 1),
    (256, 256, 132, 256, 1),
    (384, 256, 132, 0, 2),    # 3-row bands of 256: two chunks of two rows
    (256, 256, 32, 0, 4),     # 8-row bands of 256: four chunks
    (512, 128, 132, 128, 1),  # 4-row bands of 128 in 512 threads
    (64, 96, 132, 0, 1),      # one chunk at a width the step is not compiled for
    (37, 75, 132, 0, 1),
], ids=["128x128", "128x256", "256x256", "two-chunks", "four-chunks", "128x512",
        "64x96", "37x75"])
def test_step_follows_the_shape(ny, nx, max_blocks, width, chunks, monkeypatch):
    """The one-chunk step, compiled for its width, takes the grids whose
    bands are one chunk 128 or 256 wide; every other grid the general step,
    with its saved rows and mask in the footprint.  The program records
    the width it launches."""
    g, _, _, smem = schedule.bands_plan(ny, nx, max_blocks)
    assert schedule.bands_chunks(ny, nx, g) == chunks
    assert schedule.bands_width(ny, nx, g) == width
    hmax = -(-ny // g)
    assert smem == (73 * nx * (hmax + 2) if width else
                    36 * nx * (hmax + 4) + (hmax + 2) * nx)
    monkeypatch.setattr(schedule, "bands_admission", lambda device: max_blocks)
    params, obstacles, _, fcinv = _setup(ny, nx, seed=11)
    prog = fused.MultiStep(params, obstacles, fcinv, CPU, chunk=4, route="bands")
    assert prog.width == width and prog.smem_bytes == smem


@pytest.mark.parametrize("ny, nx, max_blocks, blocks, threads", [
    (37, 75, 132, 37, 96),    # fewer rows than SMs: a block a row
    (64, 96, 132, 64, 96),
    (2, 8, 132, 2, 32),       # the fewest rows, a warp for 8 cells
    (40, 24, 6, 6, 192),      # 7- and 6-row bands
    (512, 512, 132, 128, 512),   # 4-row bands: four chunks of a row
], ids=["37x75", "64x96", "2x8", "six-blocks", "512x512"])
def test_plan_of_other_grids(ny, nx, max_blocks, blocks, threads):
    """The plan covers the grid in order with ``band_of``'s bands, takes
    no more blocks than rows, and its threads cover a band or are
    BANDS_MAX_THREADS."""
    g, bands, t, smem = schedule.bands_plan(ny, nx, max_blocks)
    assert (g, t) == (blocks, threads)
    assert bands == schedule.cluster_bands(ny, g)
    assert sum(r for _, r in bands) == ny and g <= ny
    assert [row0 for row0, _ in bands] == list(np.cumsum([0] + [r for _, r in bands][:-1]))
    assert smem == schedule.bands_smem_bytes(ny, nx, g)
    assert t % 32 == 0 and t >= nx
    assert t >= max(r for _, r in bands) * nx or t == schedule.BANDS_MAX_THREADS


@pytest.mark.parametrize("ny, nx, max_blocks", [
    (1, 64, 132), (16, 513, 132), (64, 64, 0), (4096, 512, 4),
], ids=["one-row", "wider-than-a-block", "no-blocks", "beyond-shared-memory"])
def test_grids_beyond_the_bands_have_no_plan(ny, nx, max_blocks):
    assert schedule.bands_plan(ny, nx, max_blocks) is None
    assert schedule.multi_route(ny, nx, 0, max_blocks) == "grid"


def test_plan_formulas_are_the_kernels():
    """The footprint, threads and slot width of the C source are the
    schedule's."""
    src = (_build.SOURCES[0].parent / "lbm_multi_bands.cu").read_text()
    body = re.search(r"long long smem_bytes\(.*?\{(.*?)\n\}", src, re.S).group(1)
    assert "const long long hmax = (ny + g - 1) / g;" in body
    assert "if (width_of(ny, nx, g) != 0)" in body
    assert ("(2 * 9LL * nx * static_cast<long long>(sizeof(float)) + nx) * (hmax + 2);"
            in body)
    assert ("9LL * nx * static_cast<long long>(sizeof(float)) * (hmax + 4) + (hmax + 2) * nx"
            in body)
    width = re.search(r"int width_of\(.*?\{(.*?)\n\}", src, re.S).group(1)
    assert "const int hmax = (ny + g - 1) / g;" in width
    assert ("(nx == 128 || nx == 256) && static_cast<long long>(hmax) * nx <= kMaxThreads"
            in width)
    assert schedule.BANDS_STEP_WIDTHS == (128, 256)
    for w in schedule.BANDS_STEP_WIDTHS:
        assert f"kernel_of<{w}>(&fn)" in src
    threads = re.search(r"int threads_of\(.*?\{(.*?)\n\}", src, re.S).group(1)
    assert "const int lo = (nx + 31) / 32 * 32;" in threads
    assert "const long long t = (cells + 31) / 32 * 32;" in threads
    assert "ny >= 2 && g >= 1 && g <= ny && nx >= 1 && nx <= kMaxThreads" in src
    assert "constexpr int kSmemBudget = 232448 - 1024;" in src
    assert "constexpr int kMaxThreads = 512;" in src
    assert f"constexpr int kSlotPops = {schedule.BANDS_SLOT_POPS};" in src
    assert schedule.BANDS_SMEM_BUDGET == 232_448 - 1024
    assert schedule.BANDS_MAX_THREADS == 512
    assert any(p.name == "lbm_multi_bands.cu" for p in _build.SOURCES)
    for name in ("lbm_multi_bands_step", "lbm_multi_bands_smem_bytes",
                 "lbm_multi_bands_threads", "lbm_multi_bands_width"):
        assert name in _build.SIGNATURES and f"int {name}(" in src
    for ny, nx, g in ((128, 128, 128), (256, 256, 128), (37, 75, 37), (512, 512, 128),
                      (40, 24, 6), (9, 500, 3)):
        hmax = -(-ny // g)
        want = min(512, max(-(-nx // 32) * 32, -(-hmax * nx // 32) * 32))
        assert schedule.bands_threads(ny, nx, g) == want


def test_one_chunk_launches_reset_with_the_launch_counts(monkeypatch):
    monkeypatch.setitem(fused.ONE_CHUNK_LAUNCHES, "lbm_multi_bands_step", 5)
    monkeypatch.setitem(fused.LAUNCHES, "lbm_multi_bands_step", 5)
    fused.reset_launches()
    assert fused.ONE_CHUNK_LAUNCHES == {"lbm_multi_bands_step": 0}
    assert fused.LAUNCHES["lbm_multi_bands_step"] == 0
    assert not set(fused.ONE_CHUNK_LAUNCHES) - set(fused.LAUNCHES)


def test_the_card_is_asked_once_per_device(monkeypatch):
    """``bands_admission`` is the card's SM count, asked once per device;
    a failed query raises; the CPU takes an H100 SXM's 132."""
    calls = []

    class FakeLib:
        def lbm_sm_count(self, device):
            calls.append(device)
            return 114 if device == 2 else -101

    monkeypatch.setattr(_build, "load_library", FakeLib)
    schedule._card_sms.cache_clear()
    try:
        assert schedule.bands_admission(torch.device("cuda", 2)) == 114
        assert schedule.bands_admission(torch.device("cuda", 2)) == 114
        assert calls == [2]
        with pytest.raises(RuntimeError, match="cuda:5"):
            schedule.bands_admission(torch.device("cuda", 5))
        assert schedule.bands_admission(CPU) == schedule.BANDS_CPU_BLOCKS == 132
    finally:
        schedule._card_sms.cache_clear()


@pytest.mark.parametrize("ny, nx, max_blocks, steps, edge, ghost", [
    (16, 24, 132, 6, True, True),    # 1-row bands: row ny-2 a band, its neighbours' ghost
    (37, 75, 132, 5, True, True),    # 37 1-row bands, fewer rows than blocks
    (10, 400, 5, 3, True, True),     # 2-row bands of two chunks: the saved row; ny-2 a first row
    (40, 24, 6, 5, False, False),    # 7- and 6-row bands, row ny-2 inside a band
    (20, 40, 3, 4, False, False),    # 7-, 7- and 6-row bands
    (3, 8, 132, 7, True, True),      # three 1-row bands, each its neighbours' both ghosts
    (256, 128, 132, 3, True, True),  # 128x256's plan
], ids=["1-row-bands", "37x75", "two-chunks", "six-blocks", "three-blocks", "three-rows",
        "128x256"])
def test_bands_route_is_bitwise_plain_one_steps(ny, nx, max_blocks, steps, edge, ghost,
                                                monkeypatch):
    """The bands route's plain version (one copy of f in place in the
    plan's bands and chunks, ghost rows in two parities, a saved row
    between chunks) gives the bits of ``steps`` plain one-steps, with row
    ny-2 on a band edge and in a neighbour's ghost row or inside a band;
    av within AV_RTOL_STEPS (another summation order)."""
    monkeypatch.setattr(schedule, "bands_admission", lambda device: max_blocks)
    params, obstacles, f0, fcinv = _setup(ny, nx, seed=ny + nx)
    prog = fused.MultiStep(params, obstacles, fcinv, CPU, chunk=steps, route="bands")
    assert prog.route == "bands" and prog.cluster == 0
    g, bands, threads, _ = schedule.bands_plan(ny, nx, max_blocks)
    assert (prog.nblocks, prog.bands, prog.threads) == (g, bands, threads)
    assert edge == any(ny - 2 in (row0, row0 + rows - 1) for row0, rows in bands)
    assert ghost == any(ny - 2 in ((row0 - 1) % ny, (row0 + rows) % ny)
                        for row0, rows in bands)
    f = torch.from_numpy(f0)
    got, av = prog.plain_launch(f)
    ref, ref_av = _one_steps(prog, f, steps)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    np.testing.assert_allclose(av.numpy(), ref_av.numpy(), rtol=AV_RTOL_STEPS)
    np.testing.assert_array_equal(f.numpy(), f0)  # the input is left alone


@pytest.mark.parametrize("chunk", [3, 4], ids=["odd", "even"])
def test_bands_launches_keep_the_buffer_parity(chunk):
    """Launch i reads ``bufs[(i * chunk) & 1]`` and leaves the state in
    ``bufs[((i + 1) * chunk) & 1]``, where the grid-barrier kernel leaves
    it: for an even chunk the buffer it read, the other one untouched."""
    params, obstacles, f0, fcinv = _setup(18, 20, seed=50 + chunk)
    prog = fused.MultiStep(params, obstacles, fcinv, CPU, chunk=chunk, route="bands")
    f = torch.from_numpy(f0)
    ref, ref_av = _one_steps(prog, f, 3 * chunk)
    bufs = (f.clone(), torch.full_like(f, float("nan")))
    av = torch.empty(3 * chunk, dtype=torch.float32)
    launch = prog.bind(*bufs, av)
    launches, one_chunk = dict(fused.LAUNCHES), dict(fused.ONE_CHUNK_LAUNCHES)
    for i in range(3):
        launch(i)
        assert prog.final_index(i + 1) == ((i + 1) * chunk) & 1
        assert bool(bufs[prog.final_index(i + 1)].isfinite().all())
    if chunk % 2 == 0:
        assert bool(bufs[1].isnan().all())
    np.testing.assert_array_equal(bufs[prog.final_index(3)].numpy(), ref.numpy())
    np.testing.assert_allclose(av.numpy(), ref_av.numpy(), rtol=AV_RTOL_STEPS)
    assert fused.LAUNCHES == launches  # the CPU path launches nothing
    assert fused.ONE_CHUNK_LAUNCHES == one_chunk
    assert prog.epoch == 0 and prog.slots.numel() == 0  # no handoff slots on the CPU
    with pytest.raises(ValueError, match="out of range"):
        launch(3)


@pytest.mark.parametrize("cluster, blocks, ny, nx, route, nblocks", [
    ((16, 7), 132, 128, 128, "bands", 128),
    ((16, 7), 132, 256, 128, "bands", 128),
    ((16, 7), 132, 256, 256, "bands", 128),
    ((16, 7), 132, 512, 512, "grid", 0),     # four chunks a band on 128 blocks
    ((16, 7), 132, 64, 96, "cluster", 0),    # the cluster's 4-row bands of 384 cells
    ((16, 7), 132, 37, 75, "bands", 37),     # the cluster's 3-row bands
    ((16, 7), 132, 8, 640, "cluster", 0),    # rows wider than 512: one 640-cell chunk
    ((16, 7), 4, 128, 128, "cluster", 0),    # 32-row bands on 4 SMs: eight chunks
    ((8, 3), 132, 128, 128, "bands", 128),
    ((0, 0), 132, 64, 96, "bands", 64),
    ((0, 0), 16, 256, 256, "grid", 0),       # 16-row bands of 256: eight chunks
    ((0, 0), 0, 64, 96, "grid", 0),
], ids=["128x128", "128x256", "256x256", "512x512", "64x96", "37x75", "wide-rows", "4-sms",
        "8-128x128", "no-cluster", "16-sms", "none"])
def test_route_follows_the_admissions(cluster, blocks, ny, nx, route, nblocks, monkeypatch):
    """The route is decided when the program is made, from the two
    admission queries (stubbed here) and the plans; ``route=`` forces
    one, and a forced route whose plan does not fit raises."""
    monkeypatch.setattr(schedule, "cluster_admission", lambda device: cluster)
    monkeypatch.setattr(schedule, "bands_admission", lambda device: blocks)
    params, obstacles, _, fcinv = _setup(ny, nx, seed=7)
    prog = fused.MultiStep(params, obstacles, fcinv, CPU, chunk=4)
    assert (prog.route, prog.nblocks if prog.route == "bands" else 0) == (route, nblocks)
    assert prog.route == schedule.multi_route(ny, nx, cluster[0], blocks)
    if schedule.bands_plan(ny, nx, blocks) is None:
        with pytest.raises(ValueError, match="does not fit bands"):
            fused.MultiStep(params, obstacles, fcinv, CPU, chunk=4, route="bands")
    else:
        forced = fused.MultiStep(params, obstacles, fcinv, CPU, chunk=4, route="bands")
        assert forced.route == "bands"
        assert forced.nblocks == schedule.bands_plan(ny, nx, blocks)[0]
    with pytest.raises(ValueError, match="route"):
        fused.MultiStep(params, obstacles, fcinv, CPU, chunk=4, route="ring")


# µs a step of the bands, cluster and grid kernels in turns from one state
# at chunk 200 on an NVIDIA H100 80GB HBM3 (700 W): chip_smoke.py phase 3
# (PERF.md §6), the bands kernel's one-chunk step at 128^2, 128x256, 256^2.
CARD_TURNS_US = {(64, 96): (1.640, 1.508, 3.210), (37, 75): (1.644, 1.717, 4.170),
                 (128, 128): (1.150, 2.055, 3.160), (256, 128): (1.185, 3.338, 3.246),
                 (256, 256): (1.575, 6.285, 3.741)}


@pytest.mark.parametrize("grid", list(CARD_TURNS_US), ids=lambda g: f"{g[1]}x{g[0]}")
def test_route_takes_the_fastest_kernel_of_the_card_turns(grid):
    """At every grid phase 3 times, the route of a card like the one
    measured (clusters of 16, 132 SMs) is the kernel that was fastest."""
    times = dict(zip(("bands", "cluster", "grid"), CARD_TURNS_US[grid]))
    assert schedule.multi_route(*grid, 16, 132) == min(times, key=times.get)


def test_plain_bands_route_matches_pallas_kernel():
    ny, nx, chunk = 20, 32, 8
    params, obstacles, f0, fcinv = _setup(ny, nx, seed=33)
    program = build_multi_step_program(params, obstacles, fcinv, chunk, interpret=True)
    jstep = jax.jit(program.step)
    carry = program.init(jnp.asarray(f0))
    ours = fused.MultiStep(params, obstacles, fcinv, CPU, chunk=chunk, route="bands")
    assert ours.nblocks == 20 and ours.threads == 32
    bufs = (torch.from_numpy(f0.copy()), torch.empty(f0.shape, dtype=torch.float32))
    av = torch.empty(2 * chunk, dtype=torch.float32)
    launch = ours.bind(*bufs, av)
    javs = []
    for i in range(2):
        carry, jav = jstep(carry)
        javs.append(np.asarray(jav))
        launch(i)
    np.testing.assert_allclose(av.numpy(), np.concatenate(javs), rtol=AV_RTOL)
    np.testing.assert_allclose(bufs[ours.final_index(2)].numpy(),
                               np.asarray(program.final(carry)), rtol=0, atol=F_ATOL)

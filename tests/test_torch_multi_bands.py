"""The multi-step kernel across the card in bands of rows
(``csrc/lbm_multi_bands.cu``): its plan (blocks, bands, threads and
footprint), its route, its plain version (the band algorithm at its bands
and threads) against plain one-steps and against lbm_tpu's
``_step_kernel_multi``, the band algorithm itself at any bands and
threads, and the buffer parity of its launches.

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
    (64, 96, 16, 0, 1),       # 4-row bands of 384 cells
    (40, 128, 10, 128, 1),    # 4-row bands of 512 cells: the one-chunk step
], ids=["128x128", "128x256", "256x256", "two-chunks", "four-chunks", "128x512",
        "64x96", "37x75", "64x96-4-row-bands", "4-row-bands-of-512"])
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
    (64, 96, 16, 16, 384),    # 4-row bands of 384 cells
    (10, 24, 132, 10, 32),    # fewer rows than 16: a block a row
    (20, 32, 5, 5, 128),      # 4-row bands of 128 cells
], ids=["37x75", "64x96", "2x8", "six-blocks", "512x512", "64x96-on-16", "10x24",
        "20x32-on-5"])
def test_plan_of_other_grids(ny, nx, max_blocks, blocks, threads):
    """The plan covers the grid in order with ``band_of``'s bands, takes
    no more blocks than rows, and its threads cover a band or are
    BANDS_MAX_THREADS."""
    g, bands, t, smem = schedule.bands_plan(ny, nx, max_blocks)
    assert (g, t) == (blocks, threads)
    assert bands == schedule.even_bands(ny, g)
    assert sum(r for _, r in bands) == ny and g <= ny
    assert [row0 for row0, _ in bands] == list(np.cumsum([0] + [r for _, r in bands][:-1]))
    assert smem == schedule.bands_smem_bytes(ny, nx, g)
    assert t % 32 == 0 and t >= nx
    assert t >= max(r for _, r in bands) * nx or t == schedule.BANDS_MAX_THREADS


@pytest.mark.parametrize("ny, nx, max_blocks", [
    (1, 64, 132), (16, 513, 132), (64, 64, 0), (4096, 512, 4), (8, 640, 132),
    (16, 1024, 132),
], ids=["one-row", "wider-than-a-block", "no-blocks", "beyond-shared-memory", "8x640",
        "16x1024"])
def test_grids_beyond_the_bands_have_no_plan(ny, nx, max_blocks):
    assert schedule.bands_plan(ny, nx, max_blocks) is None
    assert schedule.multi_route(ny, nx, max_blocks) == "grid"


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
    """The band algorithm (one copy of f in place, ghost rows in two
    parities, chunks with a saved row) gives the bits of ``steps`` plain
    one-steps, at band edges, 1-row bands, row ny-2 on a band edge and in
    a ghost row; av within AV_RTOL_STEPS (another summation order)."""
    params, obstacles, f0, fcinv = _setup(ny, nx, seed=ny + nx)
    prog = fused.MultiStep(params, obstacles, fcinv, CPU, chunk=1, route="grid")
    c = min(16, ny)
    bands = schedule.even_bands(ny, c)
    assert kick_at_edge == any(ny - 2 in (row0, row0 + rows - 1) for row0, rows in bands)
    sweep = fused.band_sweep(ny, nx, bands, threads, CPU)
    f = torch.from_numpy(f0)
    got, av = fused.band_steps(f, prog.fluid.bool(), params, float(fcinv), sweep, steps)
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
    bands = schedule.even_bands(ny, 16)
    sweep = fused.band_sweep(ny, nx, bands, 64, CPU)
    f = torch.from_numpy(f0)
    _, av = fused.band_steps(f, prog.fluid.bool(), params, float(fcinv), sweep, 1)
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


def test_uneven_bands_cover_the_grid_in_order():
    """37 rows over 16 blocks: the first 37 % 16 bands hold 3 rows, the
    rest 2, each band starting where the last ended."""
    bands = schedule.even_bands(37, 16)
    assert [rows for _, rows in bands] == [3] * 5 + [2] * 11
    assert [row0 for row0, _ in bands] == list(np.cumsum([0] + [r for _, r in bands][:-1]))


@pytest.mark.parametrize("ny, nx, max_blocks, steps, edge, ghost", [
    (16, 24, 132, 6, True, True),    # 1-row bands: row ny-2 a band, its neighbours' ghost
    (37, 75, 132, 5, True, True),    # 37 1-row bands, fewer rows than blocks
    (10, 400, 5, 3, True, True),     # 2-row bands of two chunks: the saved row; ny-2 a first row
    (40, 24, 6, 5, False, False),    # 7- and 6-row bands, row ny-2 inside a band
    (20, 40, 3, 4, False, False),    # 7-, 7- and 6-row bands
    (3, 8, 132, 7, True, True),      # three 1-row bands, each its neighbours' both ghosts
    (256, 128, 132, 3, True, True),  # 128x256's plan
    (64, 96, 132, 4, True, True),    # 64 1-row bands
    (64, 96, 16, 5, False, False),   # 4-row bands of 384 cells
    (40, 128, 10, 6, False, False),  # 4-row bands of 512 cells
    (16, 24, 16, 6, True, True),     # the band algorithm's shapes at 16 blocks
    (20, 24, 16, 5, True, True),     # 2-row bands on 10 blocks
    (37, 75, 16, 4, True, True),     # 3- and 2-row bands on 13 blocks
    (128, 128, 16, 3, False, False),  # 8-row bands of 1,024 cells: two chunks
], ids=["1-row-bands", "37x75", "two-chunks", "six-blocks", "three-blocks", "three-rows",
        "128x256", "64x96", "64x96-4-row-bands", "4-row-bands-of-512", "16x24-on-16",
        "20x24-on-16", "37x75-on-16", "128x128-on-16"])
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
    assert prog.route == "bands"
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


@pytest.mark.parametrize("ny, nx, max_blocks, chunk", [
    pytest.param(18, 20, 132, 3, id="odd"),
    pytest.param(18, 20, 132, 4, id="even"),
    pytest.param(64, 96, 132, 3, id="64x96-odd"),
    pytest.param(64, 96, 132, 4, id="64x96-even"),
    pytest.param(64, 96, 16, 3, id="64x96-4-row-bands-odd"),
    pytest.param(64, 96, 16, 4, id="64x96-4-row-bands-even"),
])
def test_bands_launches_keep_the_buffer_parity(ny, nx, max_blocks, chunk, monkeypatch):
    """Launch i reads ``bufs[(i * chunk) & 1]`` and leaves the state in
    ``bufs[((i + 1) * chunk) & 1]``, where the grid-barrier kernel leaves
    it: for an even chunk the buffer it read, the other one untouched."""
    monkeypatch.setattr(schedule, "bands_admission", lambda device: max_blocks)
    params, obstacles, f0, fcinv = _setup(ny, nx, seed=50 + chunk)
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


@pytest.mark.parametrize("blocks, ny, nx, route, nblocks", [
    (132, 128, 128, "bands", 128),
    (132, 256, 128, "bands", 128),
    (132, 256, 256, "bands", 128),
    (132, 512, 512, "grid", 0),     # four chunks a band on 128 blocks
    (132, 64, 96, "bands", 64),
    (132, 37, 75, "bands", 37),
    (132, 8, 640, "grid", 0),       # rows wider than 512
    (4, 128, 128, "grid", 0),       # 32-row bands on 4 SMs: eight chunks
    (16, 256, 256, "grid", 0),      # 16-row bands of 256: eight chunks
    (0, 64, 96, "grid", 0),
    (16, 64, 96, "bands", 16),      # 4-row bands of 384 cells
    (8, 64, 96, "grid", 0),         # 8-row bands of 768 cells: two chunks
    (132, 10, 24, "bands", 10),     # fewer rows than 16
    (132, 20, 32, "bands", 20),
    (132, 16, 1024, "grid", 0),     # 1-row bands of 1,024 cells
    (16, 37, 75, "bands", 13),      # 3-row bands
], ids=["128x128", "128x256", "256x256", "512x512", "64x96", "37x75", "wide-rows", "4-sms",
        "16-sms", "none", "64x96-on-16", "64x96-on-8", "10x24", "20x32", "16x1024",
        "37x75-on-16"])
def test_route_follows_the_admissions(blocks, ny, nx, route, nblocks, monkeypatch):
    """The route is decided when the program is made, from the admission
    query (stubbed here) and the plan; ``route=`` forces one, and a forced
    bands route whose plan does not fit raises."""
    monkeypatch.setattr(schedule, "bands_admission", lambda device: blocks)
    params, obstacles, _, fcinv = _setup(ny, nx, seed=7)
    prog = fused.MultiStep(params, obstacles, fcinv, CPU, chunk=4)
    assert (prog.route, prog.nblocks if prog.route == "bands" else 0) == (route, nblocks)
    assert prog.route == schedule.multi_route(ny, nx, blocks)
    assert fused.MultiStep(params, obstacles, fcinv, CPU, chunk=4, route="grid").route == "grid"
    if schedule.bands_plan(ny, nx, blocks) is None:
        with pytest.raises(ValueError, match="does not fit bands"):
            fused.MultiStep(params, obstacles, fcinv, CPU, chunk=4, route="bands")
    else:
        forced = fused.MultiStep(params, obstacles, fcinv, CPU, chunk=4, route="bands")
        assert forced.route == "bands"
        assert forced.nblocks == schedule.bands_plan(ny, nx, blocks)[0]
    for other in ("ring", "cluster"):
        with pytest.raises(ValueError, match="route"):
            fused.MultiStep(params, obstacles, fcinv, CPU, chunk=4, route=other)


# µs a step of the bands and grid kernels in turns from one state at chunk
# 200 on an NVIDIA H100 80GB HBM3 (700 W): chip_smoke.py phase 3 (PERF.md
# §6), the bands kernel's one-chunk step at 128^2, 128x256, 256^2.
CARD_TURNS_US = {(64, 96): (1.640, 3.210), (37, 75): (1.644, 4.170),
                 (128, 128): (1.150, 3.160), (256, 128): (1.185, 3.246),
                 (256, 256): (1.575, 3.741)}


@pytest.mark.parametrize("grid", list(CARD_TURNS_US), ids=lambda g: f"{g[1]}x{g[0]}")
def test_route_takes_the_fastest_kernel_of_the_card_turns(grid):
    """At every grid phase 3 times, the route of a card like the one
    measured (132 SMs) is the kernel that was fastest."""
    times = dict(zip(("bands", "grid"), CARD_TURNS_US[grid]))
    assert schedule.multi_route(*grid, 132) == min(times, key=times.get)


@pytest.mark.parametrize("max_blocks, nblocks, threads", [
    pytest.param(132, 20, 32, id="1-row-bands"),
    pytest.param(5, 5, 128, id="4-row-bands"),
])
def test_plain_bands_route_matches_pallas_kernel(max_blocks, nblocks, threads, monkeypatch):
    ny, nx, chunk = 20, 32, 8
    monkeypatch.setattr(schedule, "bands_admission", lambda device: max_blocks)
    params, obstacles, f0, fcinv = _setup(ny, nx, seed=33)
    program = build_multi_step_program(params, obstacles, fcinv, chunk, interpret=True)
    jstep = jax.jit(program.step)
    carry = program.init(jnp.asarray(f0))
    ours = fused.MultiStep(params, obstacles, fcinv, CPU, chunk=chunk, route="bands")
    assert ours.nblocks == nblocks and ours.threads == threads
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

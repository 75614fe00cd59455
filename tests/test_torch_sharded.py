"""Row and 2-D sharding of the port (``lbm_tpu_torch.parallel``) on the CPU:
sharded runs against single-device runs and against ``lbm_tpu``'s sharded
runs, the temporal shard pass against plain one-steps, the halo exchange,
the mesh, the routing and its refusals, and ``bench_sharded``.

On the CPU every shard runs its plain version (the ghost-aware one-step,
the temporal window algorithm on the padded tile); the CUDA kernels are
held against those on the card by ``chip_smoke.py``.  Tolerances:

* sharded against single-device in the port: f bitwise (every cell runs
  the same operations on the same values), av rtol 1e-5 (the shards' sums
  add in another order), as ``tests/test_sharded.py`` holds ``lbm_tpu``;
* against ``lbm_tpu``'s plain sharded run: f atol 1e-6, av rtol 1e-4, the
  port's standing tolerance against ``lbm_tpu`` (``test_torch_reference``:
  the collision sums in another order);
* against ``lbm_tpu``'s Pallas sharded runs in interpret mode: f rtol 1e-5
  atol 1e-9 and av rtol 1e-4, the tolerances of ``tests/test_sharded.py``.

``lbm_tpu`` runs on the 8 virtual CPU devices of ``tests/conftest.py``.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import lbm_tpu
from lbm_tpu.parallel import sharded as jax_sharded
from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.geometry import channel_box, free_cells_of
from lbm_tpu_torch.ops import _build, fused
from lbm_tpu_torch.ops.reference import init_cells
from lbm_tpu_torch.parallel import mesh as mesh_mod
from lbm_tpu_torch.parallel import sharded
from lbm_tpu_torch.parallel.halo import HaloExchange, TileLayout, pad_mask
from lbm_tpu_torch.parallel.mesh import default_mesh, default_mesh_2d
from lbm_tpu_torch.runtime import Simulator
from lbm_tpu_torch.testing import gate_case
from lbm_tpu_torch.tools import bench_sharded

AV_RTOL = 1e-5
CPU = torch.device("cpu")
MESHES = [(1, None), (2, None), (8, None), (2, 4), (4, 2), (1, 4), (8, 1)]


@pytest.fixture(autouse=True)
def cpu_shards(monkeypatch):
    """Every mesh here puts its shards on the CPU, and the grids are small
    in parallel workers: intra-op threads only contend."""
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (conftest XLA_FLAGS)")
    return jax.devices()[:8]


def _mesh(py, px):
    return default_mesh(py) if px is None else default_mesh_2d(py, px)


def _mesh_id(m):
    return f"{m[0]}" if m[1] is None else f"{m[0]}x{m[1]}"


def _jax_params(params):
    return lbm_tpu.LBMParams(**dataclasses.asdict(params))


def _jax_mesh(py, px):
    return (jax_sharded.default_mesh(py) if px is None
            else jax_sharded.default_mesh_2d(py, px))


def _fcinv(obstacles):
    return np.float32(1.0) / np.float32(free_cells_of(obstacles))


@pytest.mark.parametrize("kernel, split", [("reference", None), ("fused", None),
                                           ("temporal", (4, 2))],
                         ids=["reference", "fused", "temporal"])
@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_sharded_matches_single_device(mesh, kernel, split):
    """32x128 from a seeded state that exercises the kick gate, 12 steps:
    every variant (on the CPU, its plain version) on every mesh."""
    params, obstacles, f0 = gate_case(32, 128, seed=7)
    params = dataclasses.replace(params, max_iters=12)
    single = Simulator(params, obstacles, kernel="reference", device=CPU).run(f0=f0)
    sim = sharded.ShardedSimulator(params, obstacles, mesh=_mesh(*mesh), kernel=kernel,
                                   temporal_split=split)
    res = sim.run(f0=f0)
    np.testing.assert_array_equal(res.f, single.f)
    np.testing.assert_allclose(res.av_vels, single.av_vels, rtol=AV_RTOL)
    assert res.n_shards == sim.mesh.size and res.steps_timed == 12


@pytest.mark.parametrize("kernel, split", [("fused", None), ("temporal", (2, 2))],
                         ids=["fused", "temporal"])
def test_body_force_row_crosses_shards(kernel, split):
    """ny = 32 over 8 shards: row ny-2 sits in the last shard's 4 rows, and
    its wake crosses the shard boundaries every step (lbm_tpu's case)."""
    params = LBMParams(128, 32, 20, 10, 0.1, 0.005, 1.85)
    obstacles = channel_box(params.nx, params.ny)
    single = Simulator(params, obstacles, kernel="reference", device=CPU).run()
    sim = sharded.ShardedSimulator(params, obstacles, mesh=default_mesh(8), kernel=kernel,
                                   temporal_split=split)
    assert sim.variant() == kernel
    np.testing.assert_array_equal(sim.run().f, single.f)


@pytest.mark.parametrize(
    "indices, runs",
    [([0, 0, 0, 0], [(0, 4)]),          # one card carries the mesh: one guard
     ([0, 1, 0, 1], [(0, 1), (1, 1), (0, 1), (1, 1)]),  # round-robin over two
     ([0, 0, 1, 1], [(0, 2), (1, 2)])],
    ids=["one-card", "round-robin", "blocks"])
def test_launch_groups_consecutive_shards_by_device(indices, runs):
    """A launch enters one device guard per run of consecutive shards on
    one device: once on one card, once per shard round-robin."""
    calls = [(torch.device("cuda", i), n) for n, i in enumerate(indices)]
    groups = sharded._by_device(calls)
    assert [(d.index, len(fns)) for d, fns in groups] == runs
    assert [fn for _, fns in groups for fn in fns] == list(range(len(indices)))


def test_each_launch_enters_one_guard_per_device_run(monkeypatch):
    """The bound launch of a 2x2 mesh on one device enters the device guard
    once a launch (the same closure several cards run, with more runs)."""
    entered = []
    guard = sharded._guard
    monkeypatch.setattr(sharded, "_guard", lambda d: entered.append(d) or guard(d))
    params, obstacles, f0 = gate_case(16, 32, seed=11)
    prog = sharded.make_sharded_fused_2d_run(dataclasses.replace(params, max_iters=6),
                                             obstacles, _fcinv(obstacles), _mesh(2, 2))
    bufs, sums = prog.alloc()
    prog.upload(bufs, f0)
    launch = prog.bind(bufs, sums)
    entered.clear()
    for i in range(6):
        launch(i)
    assert entered == [CPU] * 6


def test_program_run_of_some_launches_equals_a_shorter_run():
    """``ShardedProgram.run(f0, launches=n)``: the state and av after n of
    its launches, equal to a whole run of n * chunk steps."""
    params, obstacles, f0 = gate_case(32, 64, seed=12)
    params = dataclasses.replace(params, max_iters=12)
    prog = sharded.make_sharded_temporal_2d_run(params, obstacles, _fcinv(obstacles),
                                                _mesh(2, 2), by=4, ksteps=2)
    state, av = prog.run(f0, launches=3)
    short = sharded.ShardedSimulator(params, obstacles, mesh=_mesh(2, 2), kernel="temporal",
                                     temporal_split=(4, 2)).run(max_iters=6, f0=f0)
    np.testing.assert_array_equal(state.cpu().numpy(), short.f)
    np.testing.assert_array_equal(av.numpy(), short.av_vels)


@pytest.mark.parametrize("mesh", [(2, None), (2, 2)], ids=_mesh_id)
def test_fields_readback_equals_single_device(mesh):
    """The fields payload is computed per shard and equals the whole
    grid's to the bit (rho summed left to right in both)."""
    params, obstacles, f0 = gate_case(32, 64, seed=9)
    params = dataclasses.replace(params, max_iters=8)
    single = Simulator(params, obstacles, device=CPU).run(f0=f0, readback="fields")
    res = sharded.ShardedSimulator(params, obstacles, mesh=_mesh(*mesh),
                                   kernel="fused").run(f0=f0, readback="fields")
    assert res.f is None
    np.testing.assert_array_equal(res.fields, single.fields)
    dev = sharded.ShardedSimulator(params, obstacles, mesh=_mesh(*mesh)).run(
        f0=f0, readback="device")
    assert isinstance(dev.f, sharded.ShardedState)
    np.testing.assert_array_equal(dev.f.cpu().numpy(), Simulator(
        params, obstacles, device=CPU).run(f0=f0).f)
    assert dev.reynolds == pytest.approx(res.reynolds, rel=1e-3)


@pytest.mark.parametrize("mesh", [(4, None), (2, 4)], ids=_mesh_id)
def test_reference_matches_lbm_tpu_sharded(eight_devices, mesh):
    """The plain sharded run against lbm_tpu's jnp sharded run (its default
    on the CPU mesh), 64x128 x 30 steps."""
    params = LBMParams(128, 64, 30, 10, 0.1, 0.005, 1.85)
    obstacles = channel_box(params.nx, params.ny, interior_row=31)
    theirs = jax_sharded.ShardedSimulator(_jax_params(params), obstacles,
                                          mesh=_jax_mesh(*mesh)).run()
    ours = sharded.ShardedSimulator(params, obstacles, mesh=_mesh(*mesh),
                                    kernel="reference").run()
    np.testing.assert_allclose(ours.f, theirs.f, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours.av_vels, theirs.av_vels, rtol=1e-4)


def test_fused_matches_lbm_tpu_pallas_interpret(eight_devices):
    """kernel="fused" on 2 row shards (on both sides the routing starts
    with the temporal variant) against lbm_tpu's Pallas kernels in
    interpret mode, 32x128 x 12 steps."""
    params = LBMParams(128, 32, 12, 10, 0.1, 0.005, 1.85)
    obstacles = channel_box(params.nx, params.ny, interior_row=13)
    theirs = jax_sharded.ShardedSimulator(_jax_params(params), obstacles,
                                          mesh=_jax_mesh(2, None), kernel="fused",
                                          interpret=True).run()
    ours = sharded.ShardedSimulator(params, obstacles, mesh=_mesh(2, None),
                                    kernel="fused").run()
    np.testing.assert_allclose(ours.f, theirs.f, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(ours.av_vels, theirs.av_vels, rtol=1e-4)


def test_temporal_matches_lbm_tpu_pallas_interpret(eight_devices):
    """make_sharded_temporal_run(by=8, ksteps=2) on both sides, 64x128 x 12
    steps over 2 row shards (lbm_tpu's tests/test_sharded.py case)."""
    params = LBMParams(128, 64, 12, 10, 0.1, 0.005, 1.85)
    obstacles = channel_box(params.nx, params.ny, interior_row=29)
    fcinv = _fcinv(obstacles)
    run = jax_sharded.make_sharded_temporal_run(_jax_params(params), obstacles, fcinv,
                                                _jax_mesh(2, None), by=8, ksteps=2,
                                                interpret=True)
    jf, javs = run(lbm_tpu.ops.reference.init_cells(_jax_params(params)))
    ours = sharded.make_sharded_temporal_run(params, obstacles, fcinv,
                                             _mesh(2, None), by=8, ksteps=2)
    assert ours.variant == "temporal" and ours.chunk == 2
    f, av = ours(init_cells(params))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(av.numpy(), np.asarray(javs), rtol=1e-4)


def _padded(f, layout, y0, x0):
    """The padded buffer of the tile at (y0, x0), its halo filled from the
    global ``f`` by periodic index (what the exchange builds)."""
    ny, nx = f.shape[1:]
    h = layout.halo
    rows = (y0 - h + torch.arange(layout.rows)) % ny
    cols = (x0 - h + torch.arange(layout.nxl + 2 * h)) % nx
    buf = torch.zeros(layout.shape, dtype=torch.float32)
    layout.ext(buf)[:] = f[:, rows[:, None], cols]
    return buf


@pytest.mark.parametrize(
    "ny, nx, nyl, nxl, y0, x0, by, bx, k",
    [
        (32, 48, 32, 48, 0, 0, 8, 16, 4),     # one shard: every halo wraps onto it
        (32, 48, 16, 24, 16, 24, 8, 8, 3),    # the top-right shard of 2x2: row ny-2
        (24, 40, 12, 20, 0, 20, 2, 10, 5),    # K > BY; ny-2 in the south halo, wrapped
    ],
    ids=["one-shard", "kick-shard", "k-gt-by"],
)
def test_temporal_shard_pass_equals_k_plain_steps(ny, nx, nyl, nxl, y0, x0, by, bx, k):
    params, obstacles, f0 = gate_case(ny, nx, seed=ny + k)
    fcinv = _fcinv(obstacles)
    layout = TileLayout(nyl, nxl, k)
    prog = fused.ShardTemporalStep(params, pad_mask(~obstacles, layout, y0, x0), layout,
                                   y0, fcinv, CPU, by, bx)
    f = torch.from_numpy(f0)
    out, sums = prog.plain_launch(_padded(f, layout, y0, x0))
    step = fused.ReferenceStep(params, obstacles, fcinv, CPU)
    ref = f
    for _ in range(k):
        ref, _ = step.plain(ref)
    np.testing.assert_array_equal(out.numpy(), ref[:, y0:y0 + nyl, x0:x0 + nxl].numpy())
    assert sums.shape == (k,)
    # The one-step shard program on the same tile: one plain step.
    one_layout = TileLayout(nyl, nxl, 1)
    one = fused.ShardStep(params, pad_mask(~obstacles, one_layout, y0, x0), one_layout,
                          y0, fcinv, CPU)
    out1, _ = one.plain_launch(_padded(f, one_layout, y0, x0))
    np.testing.assert_array_equal(out1.numpy(),
                                  step.plain(f)[0][:, y0:y0 + nyl, x0:x0 + nxl].numpy())


@pytest.mark.parametrize("mesh", [(2, None), (4, None), (2, 2)], ids=_mesh_id)
def test_shard_route_at_the_default_tile_matches_single_device(mesh):
    """The sharded temporal route at the fixed order's tile (32x64, K 4)
    on 128x256 (row ny-2 in the last shard), 8 steps: f bitwise the
    single-device TemporalStep plain program's at the same tile, av within
    AV_RTOL."""
    params, obstacles, f0 = gate_case(128, 256, seed=23)
    params = dataclasses.replace(params, max_iters=8)
    fcinv = _fcinv(obstacles)
    prog = fused.TemporalStep(params, obstacles, fcinv, CPU, 32, 64, 4)
    bufs = (torch.from_numpy(f0.copy()), torch.empty(f0.shape, dtype=torch.float32))
    av = torch.empty(8, dtype=torch.float32)
    launch = prog.bind(*bufs, av)
    for i in range(2):
        launch(i)
    sim = sharded.ShardedSimulator(params, obstacles, mesh=_mesh(*mesh), kernel="temporal")
    first = sim.compiled().shards[0][0]
    assert isinstance(first, fused.ShardTemporalStep)
    assert (first.by, first.bx, first.chunk) == (32, 64, 4)
    res = sim.run(f0=f0)
    np.testing.assert_array_equal(res.f, bufs[prog.final_index(2)].numpy())
    np.testing.assert_allclose(res.av_vels, av.numpy(), rtol=AV_RTOL)


@pytest.mark.parametrize(
    "nyl, nxl, halo, by, bx, match",
    [
        (64, 256, 4, 24, 64, "does not divide"),
        (64, 256, 4, 32, 48, "does not divide"),
        (64, 256, 4, 64, 128, "shared memory"),
        (64, 256, 2, 8, 256, "shared memory"),  # fits the one-tile window kernels' budget only
        (4, 256, 6, 2, 64, "halo needs a tile"),  # K > nyl: the layout refuses
    ],
    ids=["by", "bx", "window", "window-not-xtiled", "k-gt-nyl"],
)
def test_shard_temporal_refuses_shapes_before_any_launch(nyl, nxl, halo, by, bx, match,
                                                         monkeypatch):
    """Every shape the shard entry does not take raises ValueError before
    the library is built or anything launches."""
    params, obstacles, _ = gate_case(64, 256, seed=31)

    def no_build():
        raise AssertionError("built the library before refusing the shape")

    monkeypatch.setattr(_build, "load_library", no_build)
    launches = dict(fused.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        layout = TileLayout(nyl, nxl, halo)
        fused.ShardTemporalStep(params, pad_mask(~obstacles, layout, 0, 0), layout, 0,
                                _fcinv(obstacles), torch.device("cuda", 0), by, bx)
    assert fused.LAUNCHES == launches


@pytest.mark.parametrize("mesh, h", [((1, 1), 1), ((2, 2), 2), ((3, 1), 3), ((2, 3), 1)],
                         ids=["1x1-h1", "2x2-h2", "3x1-h3", "2x3-h1"])
def test_halo_exchange_fills_the_periodic_halo(mesh, h):
    """After one exchange every tile's owned cells and halo equal the
    global grid around it, corners included, with periodic wrap."""
    py, px = mesh
    nyl, nxl = 5, 7
    f = torch.from_numpy(np.random.default_rng(3).random((9, py * nyl, px * nxl),
                                                          dtype=np.float32))
    layout = TileLayout(nyl, nxl, h)
    tiles = [[torch.full(layout.shape, np.nan) for _ in range(px)] for _ in range(py)]
    for iy in range(py):
        for ix in range(px):
            layout.interior(tiles[iy][ix])[:] = f[:, iy * nyl:(iy + 1) * nyl,
                                                  ix * nxl:(ix + 1) * nxl]
    HaloExchange(tiles, layout)()
    for iy in range(py):
        for ix in range(px):
            want = layout.ext(_padded(f, layout, iy * nyl, ix * nxl))
            np.testing.assert_array_equal(layout.ext(tiles[iy][ix]).numpy(), want.numpy())
    assert layout.lpad % 32 == 0 and layout.stride % 32 == 0 and layout.lpad >= h
    assert layout.halo_bytes() == 2 * h * (nxl + nyl + 2 * h) * 9 * 4


def test_tile_layout_and_mask():
    with pytest.raises(ValueError, match="halo"):
        TileLayout(3, 8, 4)
    layout = TileLayout(4, 6, 2)
    fluid = np.arange(8 * 12).reshape(8, 12) % 3 != 0
    m = pad_mask(fluid, layout, 4, 6)
    assert m.dtype == np.uint8 and m.shape == (layout.rows, layout.stride)
    np.testing.assert_array_equal(layout.interior(torch.from_numpy(m)).numpy(),
                                  fluid[4:8, 6:12])
    # Halo from the neighbours with wrap; nothing outside it.
    np.testing.assert_array_equal(m[0, layout.lpad - 2:layout.lpad],
                                  fluid[2, [4, 5]])
    assert not m[:, :layout.lpad - 2].any() and not m[:, layout.lpad + 8:].any()


def test_mesh_placement(monkeypatch):
    """Shards go to the visible devices round-robin (one card carries any
    mesh); LBM_DEVICE=cpu puts them on the CPU; without CUDA and without
    cpu, making a mesh raises."""
    m = default_mesh_2d(2, 4)
    assert m.shape == {"y": 2, "x": 4} and m.size == 8
    assert all(d == CPU for d in m.devices.flat)
    assert default_mesh(3).shape == {"y": 3} and default_mesh().size == 1
    assert m.describe() == "2x4 (rows x cols), 8 shard(s): cpu x8"
    monkeypatch.setattr(mesh_mod, "visible_devices",
                        lambda: [torch.device("cuda", 0), torch.device("cuda", 1)])
    assert [d.index for d in default_mesh(5).devices] == [0, 1, 0, 1, 0]
    assert [[d.index for d in row] for row in default_mesh_2d(2, 3).devices] == [
        [0, 1, 0], [1, 0, 1]]
    monkeypatch.undo()
    monkeypatch.delenv("LBM_DEVICE", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="LBM_DEVICE=cpu"):
            default_mesh(2)
    with pytest.raises(ValueError, match="positive"):
        default_mesh_2d(0, 2)
    assert mesh_mod._rings(3) == ([(0, 1), (1, 2), (2, 0)], [(0, 2), (1, 0), (2, 1)])


@pytest.mark.parametrize(
    "mesh, kernel, split, steps, variant",
    [
        ((2, None), "fused", None, 12, "temporal"),
        ((2, None), "fused", None, 13, "fused"),      # no K divides 13
        ((2, None), "temporal", (8, 4), 12, "temporal"),
        ((2, None), "auto", None, 12, "reference"),  # auto is reference on the CPU
        ((2, 2), "fused", None, 12, "fused"),
        ((2, 2), "fused", (4, 2), 12, "temporal"),
        ((2, 2), "temporal", None, 12, "temporal"),
        ((2, 2), "reference", None, 12, "reference"),
    ],
)
def test_routing(mesh, kernel, split, steps, variant):
    """lbm_tpu's order: 1-D fused tries temporal, then fused; 2-D fused
    tries fused (temporal first with a split)."""
    params = LBMParams(64, 32, steps, 10, 0.1, 0.005, 1.85)
    sim = sharded.ShardedSimulator(params, channel_box(64, 32), mesh=_mesh(*mesh),
                                   kernel=kernel, temporal_split=split)
    assert sim.variant() == variant
    prog = sim.compiled()
    assert prog.chunk == sim.chunk() and steps % prog.chunk == 0
    if variant == "temporal":
        first = prog.shards[0][0]
        assert isinstance(first, fused.ShardTemporalStep)
        assert prog.layout.halo == first.chunk
        if split is not None:
            assert (first.by, first.chunk) == split
    assert sim.run().steps_per_pass == prog.chunk


@pytest.mark.parametrize(
    "kwargs, steps, err, match",
    [
        ({"kernel": "temporal"}, 13, ValueError, "no valid temporal"),
        ({"kernel": "temporal", "temporal_split": (5, 2)}, 12, ValueError,
         "does not divide"),
        ({"kernel": "temporal", "temporal_split": (8, 5)}, 12, ValueError, "K | max_iters"),
        ({"kernel": "fused", "temporal_split": (8, 4, 2), "mesh": (2, 2)}, 12, ValueError,
         "x shard"),
        ({"kernel": "mega"}, 12, ValueError, "single-chip"),
        ({"kernel": "reference", "temporal_split": (8, 4)}, 12, ValueError, "requires"),
        ({"mesh": (3, None)}, 12, ValueError, "not divisible"),
        ({"mesh": (2, 3)}, 12, ValueError, "not divisible"),
    ],
    ids=["no-split", "bad-by", "bad-k", "xtiled", "mega", "split-reference",
         "ny-mesh", "nx-mesh"],
)
def test_refusals(kwargs, steps, err, match):
    """lbm_tpu's refusals; and the x-tiled split (px=2) of the 1-D temporal
    factory runs, f bitwise the single-device plain run's."""
    params = LBMParams(64, 32, steps, 10, 0.1, 0.005, 1.85)
    mesh = _mesh(*kwargs.pop("mesh", (2, None)))
    with pytest.raises(err, match=match):
        sharded.ShardedSimulator(params, channel_box(64, 32), mesh=mesh,
                                 **kwargs).compiled()
    obstacles = channel_box(64, 32)
    xt = sharded.make_sharded_temporal_run(params, obstacles, _fcinv(obstacles),
                                           default_mesh(2), 12, by=8, ksteps=2, px=2)
    assert isinstance(xt.shards[0][0], fused.ShardTemporalXtStep)
    single = Simulator(dataclasses.replace(params, max_iters=12), obstacles,
                       kernel="reference", device=CPU).run()
    np.testing.assert_array_equal(xt()[0].numpy(), single.f)


def test_shard_programs_never_take_the_plain_path_on_other_devices(monkeypatch):
    """On a device that is not the CPU a shard program launches its kernel
    or raises; a failed build raises where the program is made."""
    params, obstacles, _ = gate_case(8, 16, seed=80)
    fcinv = _fcinv(obstacles)
    for cls, halo, extra in ((fused.ShardStep, 1, ()),
                             (fused.ShardTemporalStep, 2, (4, 8))):
        layout = TileLayout(8, 16, halo)
        prog = cls(params, pad_mask(~obstacles, layout, 0, 0), layout, 0, fcinv, CPU,
                   *extra)

        def no_plain(*args, **kwargs):
            raise AssertionError("the CUDA path fell back to the plain version")

        monkeypatch.setattr(prog, "plain_launch", no_plain)
        f = torch.empty(layout.shape, device="meta")
        sums = torch.empty(halo, device="meta")

        def failing_build():
            raise _build.BuildError("simulated build failure")

        monkeypatch.setattr(_build, "load_library", failing_build)
        with pytest.raises(_build.BuildError, match="simulated"):
            prog.bind(f, torch.empty_like(f), sums)
        with pytest.raises(_build.BuildError, match="simulated"):
            cls(params, pad_mask(~obstacles, layout, 0, 0), layout, 0, fcinv,
                torch.device("cuda", 0), *extra)
        launches = dict(fused.LAUNCHES)
        monkeypatch.setattr(_build, "load_library", lambda: object())
        with pytest.raises(ValueError, match="CUDA or CPU"):
            prog.bind(f, torch.empty_like(f), sums)
        assert fused.LAUNCHES == launches
        monkeypatch.undo()


def test_bench_sharded_smoke(capsys):
    assert bench_sharded.main(["--ny", "32", "--nx", "64", "--max-iters", "8",
                               "--mesh", "2x2", "--kernel", "temporal",
                               "--repeats", "1"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["shards"] == 4 and rec["kernel"] == "temporal" and rec["chunk"] == 4
    assert rec["total_mlups"] > 0 and rec["devices"] == ["cpu"]
    assert "not a multi-GPU rate" in rec["note"]
    layout = TileLayout(16, 32, 4)
    assert rec["halo_bytes_per_step_per_shard"] == layout.halo_bytes() / 4
    assert rec["halo_bytes_per_step"] == 4 * rec["halo_bytes_per_step_per_shard"]

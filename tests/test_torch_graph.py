"""The graph route (``lbm_tpu_torch.graphs``) on the CPU: the whole run as
replays of a period graph and a remainder graph.

On the CPU the capture is a :class:`~lbm_tpu_torch.graphs.Recorder`: it
records each ``launch(i)`` (and the launch's prologue) and replays the
recording, so the period, the parity, the scratch av and the remainder
are the same code that replays CUDA graphs on the card, where
``chip_smoke.py`` holds every route's graph against its eager run.  The
recorded route must equal the eager route to the bit, f and av, for every
program kind and mesh, for launch counts the period divides and ones it
does not, and over checkpoint segments.  One sharded case is held against
``lbm_tpu``'s ``ShardedSimulator`` in interpret mode on the 8 virtual CPU
devices, at the tolerances of ``tests/test_torch_sharded.py`` (f atol
1e-6, av rtol 1e-4: the collision sums in another order).
"""

import contextlib
import dataclasses
import gc
import types
import weakref

import jax
import numpy as np
import pytest
import torch

import lbm_tpu
from lbm_tpu.parallel import sharded as jax_sharded
from lbm_tpu_torch import graphs, runtime
from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.geometry import channel_box, free_cells_of
from lbm_tpu_torch.ops import fused, schedule
from lbm_tpu_torch.parallel import sharded
from lbm_tpu_torch.parallel.mesh import default_mesh, default_mesh_2d
from lbm_tpu_torch.runtime import Simulator
from lbm_tpu_torch.testing import gate_case
from lbm_tpu_torch.utils import debugging, profiling

CPU = torch.device("cpu")
PERIOD = 4  # launches a period graph holds here: several replays at small sizes


@pytest.fixture(autouse=True)
def small_period(monkeypatch):
    """Period graphs of PERIOD launches, every shard on the CPU, one
    intra-op thread (the grids are small, the workers parallel)."""
    monkeypatch.setattr(graphs, "PERIOD", PERIOD)
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fcinv(obstacles):
    return np.float32(1.0) / np.float32(free_cells_of(obstacles))


def _bits_equal(a, b):
    a = np.ascontiguousarray(np.asarray(a, dtype=np.float32))
    b = np.ascontiguousarray(np.asarray(b, dtype=np.float32))
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


# Each program kind on a 16x32 grid, and (kind, launches): launch counts
# PERIOD divides (4, 8, 12) and ones it does not (1, 5, 7, 9: a remainder
# graph only, or periods and a remainder).
PROGRAMS = {
    "one-step": lambda p, o, c: fused.FusedStep(p, o, c, CPU),
    "bands": lambda p, o, c: fused.MultiStep(p, o, c, CPU, 3, route="bands"),
    "temporal": lambda p, o, c: fused.TemporalStep(p, o, c, CPU, 8, 16, 2),
    "x-tiled": lambda p, o, c: fused.TemporalXtStep(p, o, c, CPU, 8, 16, 2),
    "mega": lambda p, o, c: fused.MegaStep(p, o, c, CPU, 8, 16, 2, 3),
}
CASES = [("one-step", 9), ("one-step", 8), ("bands", 7), ("bands", 12),
         ("temporal", 9), ("temporal", 1), ("x-tiled", 9), ("x-tiled", 8), ("mega", 5),
         ("mega", 4)]


def _simulator(kind, launches, seed=3):
    params, obstacles, f0 = gate_case(16, 32, seed)
    prog = PROGRAMS[kind](params, obstacles, _fcinv(obstacles))
    steps = launches * prog.chunk
    sim = Simulator(dataclasses.replace(params, max_iters=steps), obstacles, device=CPU)
    sim._programs[steps] = prog
    return sim, steps, f0


@pytest.mark.parametrize("kind, launches", CASES, ids=[f"{k}-{n}" for k, n in CASES])
def test_recorded_route_equals_eager(kind, launches):
    """Every program kind: the graph route's f and av the eager route's
    bits, twice in a row from one compiled run (a run reuses its
    recording)."""
    sim, steps, f0 = _simulator(kind, launches)
    eager = sim.compiled(steps, route="eager")
    graph = sim.compiled(steps)
    assert graph.route == "graph" and eager.route == "eager"
    fe, ave = eager(f0)
    fe = fe.clone()  # both runs of one Simulator bind the same f buffers
    for _ in range(2):
        fg, avg = graph(f0)
        _bits_equal(fg, fe)
        _bits_equal(avg, ave)


@pytest.mark.parametrize("kind", ["bands", "x-tiled"])
def test_run_names_route_and_matches_eager(kind):
    """``Simulator.run`` on both routes, every readback: the same bits."""
    sim, steps, f0 = _simulator(kind, 6, seed=4)
    for readback in ("state", "fields"):
        g = sim.run(f0=f0, readback=readback)
        e = sim.run(f0=f0, readback=readback, route="eager")
        _bits_equal(g.f if readback == "state" else g.fields,
                    e.f if readback == "state" else e.fields)
        _bits_equal(g.av_vels, e.av_vels)


def _profiled(fn):
    profiling.take_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.take_spans()


REUSED = [(kind, route) for kind in ("bands", "temporal", "x-tiled")
          for route in ("graph", "eager")]


@pytest.mark.parametrize("kind, route", REUSED, ids=[f"{k}-{r}" for k, r in REUSED])
def test_a_kept_run_is_a_fresh_simulators_run(kind, route):
    """Two runs on one Simulator from two states (6 launches: a period
    graph replayed once and a remainder graph): av and fields the bits of
    a fresh Simulator's run from each state, and the second run makes
    nothing: its ``runtime.prepare`` reused the first run's, with no
    program, buffer or capture made."""
    sim, steps, f0 = _simulator(kind, 6, seed=9)
    f1 = gate_case(16, 32, 10)[2]
    first = sim.run(f0=f0, readback="fields", route=route)
    second, spans = _profiled(lambda: sim.run(f0=f1, readback="fields", route=route))
    assert not np.array_equal(first.av_vels, second.av_vels)
    for f, kept in ((f0, first), (f1, second)):
        fresh = _simulator(kind, 6, seed=9)[0].run(f0=f, readback="fields", route=route)
        _bits_equal(kept.av_vels, fresh.av_vels)
        _bits_equal(kept.fields, fresh.fields)
    (prepare,) = [s for s in spans if s.name == "runtime.prepare"]
    assert prepare.attrs == {"reused": 1}
    made = {"runtime.program", "runtime.alloc", "graphs.capture"}
    assert not made & {s.name for s in spans}


def test_each_length_readback_and_route_compiles_its_own_run():
    """A run is kept per (max_iters, readback, route), "device" sharing
    "state"'s; ``nan_guard``'s eager route is its own key.  Every kept run
    binds the Simulator's one set of f buffers."""
    sim, steps, f0 = _simulator("bands", 6)
    fn = sim.compiled(steps)
    assert sim.compiled(steps) is fn and sim.compiled(steps, "device") is fn
    fields, eager = sim.compiled(steps, "fields"), sim.compiled(steps, route="eager")
    shorter = sim.compiled(steps // 2)
    assert len({id(g) for g in (fn, fields, eager, shorter)}) == 4
    with debugging.nan_guard():
        assert sim.compiled(steps) is eager
    for g in (fields, eager, shorter):
        assert [b.data_ptr() for b in g.buffers] == [b.data_ptr() for b in fn.buffers]
    _, spans = _profiled(lambda: (sim.compiled(steps // 2, "fields"), sim.compiled(steps)))
    made, kept = [s for s in spans if s.name == "runtime.prepare"]
    assert made.attrs == {"reused": 0} and kept.attrs == {"reused": 1}
    assert "graphs.capture" in {s.name for s in spans if s.parent == made.id}
    assert not [s for s in spans if s.parent == kept.id]


def test_a_device_readback_outlives_the_next_run():
    """``readback="device"`` hands back a copy: a later run on the same
    Simulator, which rewrites its buffers, leaves it as it was."""
    sim, steps, f0 = _simulator("bands", 6)
    kept = sim.run(f0=f0, readback="device").f
    bits = kept.clone()
    f1 = gate_case(16, 32, 4)[2]
    sim.run(f0=f1, readback="device")
    sim.run(f0=f1, readback="state", route="eager")
    assert torch.equal(kept.view(torch.int32), bits.view(torch.int32))
    assert all(kept.data_ptr() != b.data_ptr() for b in sim.compiled(steps).buffers)


@pytest.mark.parametrize("kind", ["bands", "temporal", "x-tiled"])
def test_a_dropped_simulator_frees_its_buffers_at_once(kind):
    """No kept run holds its Simulator: with the cycle collector off, the
    Simulator's f buffers are freed when the Simulator is dropped."""
    sim, steps, f0 = _simulator(kind, 6)
    sim.run(f0=f0, readback="fields")
    sim.run(f0=f0, route="eager")
    buffer = weakref.ref(sim.compiled(steps).buffers[0])
    collecting = gc.isenabled()
    gc.disable()
    try:
        assert buffer() is not None
        del sim
        assert buffer() is None
    finally:
        if collecting:
            gc.enable()


class LoggingRecorder(graphs.Recorder):
    """A recorder whose replays log each call: the name of a prologue
    call, or the launch index."""

    log: list = []

    def replay(self):
        for fn, args in self.plan:
            LoggingRecorder.log.append(args[0] if args else fn.__name__)
            fn(*args)


def test_bands_plan_resets_slots_before_every_replay():
    """The bands route bakes its epochs into a graph, so each graph starts
    by zeroing its slots: the recorded plan of a bands program holds the
    reset of ``program.slots`` before the first launch, and every replay,
    period or remainder, makes it first."""
    params, obstacles, f0 = gate_case(16, 32, 5)
    prog = fused.MultiStep(params, obstacles, _fcinv(obstacles), CPU, 2, route="bands")
    bufs = [torch.from_numpy(f0.copy()), torch.empty(9, 16, 32)]
    av = torch.empty(2 * (3 * PERIOD + 1))
    runner = graphs.GraphRunner(lambda s: prog.bind(*bufs, s[0]), 3 * PERIOD + 1, 2, [av],
                                LoggingRecorder)
    for graph in (runner.main, runner.tail):
        fn, args = graph.plan[0]
        assert fn.__name__ == "zero_" and fn.__self__ is prog.slots and args == ()
        assert [a for _, a in graph.plan[1:]] == [(i,) for i in range(len(graph.plan) - 1)]
    LoggingRecorder.log = []
    runner.run([av])
    period = ["zero_", *range(PERIOD)]
    assert LoggingRecorder.log == period * 3 + ["zero_", 0]


def test_inplace_plan_fills_bands_first():
    """An in-place program's graphs start by filling the bands of parity 0
    from f (its launch's prologue), so each replay starts as a fresh run."""
    sim, steps, f0 = _simulator("x-tiled", 5)
    prog = sim.program_for(steps)
    carry = prog.init(torch.from_numpy(f0.copy()))
    launch = prog.bind_carry(carry, torch.empty(steps))
    carry.bands.fill_(float("nan"))
    carry.parity = 1
    (start,) = launch.prologue
    start()
    assert carry.parity == 0 and bool(torch.isfinite(carry.bands[0]).all())


def test_runner_scratch_and_remainder(monkeypatch):
    """The runner's bookkeeping alone: launch i of a period writes scratch
    slots [i*chunk, (i+1)*chunk), each replay's scratch lands at its run's
    offset, the remainder after the last period."""
    calls = []

    def bind(scratch):
        (s,) = scratch

        def launch(i):
            calls.append(i)
            s[i * 3:(i + 1) * 3] = torch.arange(3) + 10 * i

        return launch

    runner = graphs.GraphRunner(bind, 11, 3, [torch.empty(0)], graphs.Recorder)
    assert (runner.reps, runner.rest, runner.scratch[0].numel()) == (2, 3, 3 * PERIOD)
    out = torch.full((33,), -1.0)
    runner.run([out])
    want = torch.cat([torch.arange(3) + 10 * (i % PERIOD) for i in range(11)]).float()
    assert torch.equal(out, want)
    assert calls == [*range(PERIOD), *range(PERIOD), 0, 1, 2]
    monkeypatch.setattr(graphs, "PERIOD", 3)
    with pytest.raises(ValueError, match="even"):
        graphs.GraphRunner(bind, 4, 3, [torch.empty(0)], graphs.Recorder)


class _NoGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: a replay launches nothing."""

    def replay(self):
        pass


@pytest.mark.parametrize("blocks, one_chunk", [(4, True), (2, False)],
                         ids=["one-chunk", "two-chunks"])
def test_cuda_graph_counts_launches_at_replay(monkeypatch, blocks, one_chunk):
    """A CUDA graph of the bands kernel's launches counts each launch, and
    each that took the one-chunk step, once a replay and never at its
    capture: ``LAUNCHES`` and ``ONE_CHUNK_LAUNCHES`` both read the run's
    launches (0 one-chunk launches where a band takes two chunks).  The
    bound launches call a stand-in library, and the graph calls of
    ``torch.cuda`` launch nothing."""
    for name, stub in (("CUDAGraph", _NoGraph), ("Stream", lambda device: None),
                       ("stream", lambda s: contextlib.nullcontext()),
                       ("graph", lambda g, stream=None: contextlib.nullcontext()),
                       ("device", lambda d: contextlib.nullcontext()),
                       ("current_stream", lambda d=None: types.SimpleNamespace(cuda_stream=0))):
        monkeypatch.setattr(torch.cuda, name, stub)
    lib = types.SimpleNamespace(lbm_multi_bands_step=lambda *args: 0)
    monkeypatch.setattr(fused._build, "load_library", lambda: lib)
    monkeypatch.setattr(fused, "runs_plain", lambda x: False)
    monkeypatch.setattr(schedule, "bands_admission", lambda device: blocks)
    params, obstacles, f0 = gate_case(16, 128, 5)
    prog = fused.MultiStep(params, obstacles, _fcinv(obstacles), CPU, 2, route="bands")
    assert bool(prog.width) == one_chunk
    monkeypatch.setattr(prog, "_check_cuda", lambda *tensors: None)
    bufs = [torch.from_numpy(f0.copy()), torch.empty(9, 16, 128)]
    av = torch.empty(2 * (3 * PERIOD + 1))
    fused.reset_launches()
    runner = graphs.GraphRunner(lambda s: prog.bind(*bufs, s[0]), 3 * PERIOD + 1, 2, [av],
                                lambda: graphs.CudaGraph(CPU))
    assert fused.LAUNCHES["lbm_multi_bands_step"] == 0
    assert fused.ONE_CHUNK_LAUNCHES["lbm_multi_bands_step"] == 0
    runner.run([av])
    runner.run([av])
    assert fused.LAUNCHES["lbm_multi_bands_step"] == 2 * (3 * PERIOD + 1)
    assert fused.ONE_CHUNK_LAUNCHES["lbm_multi_bands_step"] == (
        fused.LAUNCHES["lbm_multi_bands_step"] if one_chunk else 0)
    fused.reset_launches()


MESHES = [(1, None), (2, None), (8, None), (2, 4), (4, 2), (1, 4), (8, 1)]
# (mesh, kernel, split, steps): the one-step and temporal kinds on every mesh
# of test_torch_sharded.py, the x-tiled kind on those of one column.
SHARDED = ([(m, "fused", None, 9) for m in MESHES]
           + [(m, "temporal", (4, 2), 18) for m in MESHES]
           + [(m, "temporal", (4, 2, 2), 10) for m in MESHES if m[1] in (None, 1)])


def _mesh(py, px):
    return default_mesh(py) if px is None else default_mesh_2d(py, px)


def _case_id(case):
    (py, px), kernel, split, _ = case
    kind = "x-tiled" if split is not None and len(split) == 3 else kernel
    return f"{kind}-{py}" + ("" if px is None else f"x{px}")


@pytest.mark.parametrize("mesh, kernel, split, steps", SHARDED,
                         ids=[_case_id(c) for c in SHARDED])
def test_sharded_recorded_route_equals_eager(mesh, kernel, split, steps):
    """Every sharded program kind over the meshes of
    ``test_torch_sharded.py`` (the x-tiled route on the meshes of one
    column): the graph route's f and av the eager route's bits, by
    ``ShardedProgram.prepare`` and by ``ShardedSimulator.run``."""
    params, obstacles, f0 = gate_case(32, 64, seed=8)
    params = dataclasses.replace(params, max_iters=steps)
    sim = sharded.ShardedSimulator(params, obstacles, mesh=_mesh(*mesh), kernel=kernel,
                                   temporal_split=split)
    prog = sim.compiled()
    if split is not None and len(split) == 3:
        assert isinstance(prog, sharded.ShardedXtProgram)
    assert sim.launch_route() == "graph"
    ge, ave = prog.prepare(route="eager")(f0)
    gg, avg = prog.prepare()(f0)
    _bits_equal(gg.cpu(), ge.cpu())
    _bits_equal(avg, ave)
    g = sim.run(f0=f0)
    e = sim.run(f0=f0, route="eager")
    _bits_equal(g.f, e.f)
    _bits_equal(g.av_vels, e.av_vels)


def test_sharded_recorded_route_matches_lbm_tpu_interpret(eight_devices):
    """The graph route of kernel="fused" on 2 row shards (the temporal
    variant on both sides) against lbm_tpu's Pallas kernels in interpret
    mode, 32x128 x 12 steps."""
    params = LBMParams(128, 32, 12, 10, 0.1, 0.005, 1.85)
    obstacles = channel_box(params.nx, params.ny, interior_row=13)
    theirs = jax_sharded.ShardedSimulator(lbm_tpu.LBMParams(**dataclasses.asdict(params)),
                                          obstacles, mesh=jax_sharded.default_mesh(2),
                                          kernel="fused", interpret=True).run()
    sim = sharded.ShardedSimulator(params, obstacles, mesh=_mesh(2, None), kernel="fused")
    assert sim.launch_route() == "graph"
    ours = sim.run()
    np.testing.assert_allclose(ours.f, theirs.f, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours.av_vels, theirs.av_vels, rtol=1e-4)


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (conftest XLA_FLAGS)")
    return jax.devices()[:8]


# (kind, max_iters, every, half): segments of every steps and a shorter tail,
# each a whole number of the program's launches, also after a resume.
SEGMENTS = [("bands", 21, 9, 9), ("one-step", 10, 4, 4), ("temporal", 14, 6, 6)]


@pytest.mark.parametrize("kind, steps, every, half", SEGMENTS, ids=[c[0] for c in SEGMENTS])
def test_checkpoint_segments_equal_eager(tmp_path, kind, steps, every, half):
    """Segments of ``every`` steps and a shorter tail, each length compiled
    once and replayed for every segment: the graph route's snapshot and
    av the eager route's bits, and a resume from ``half`` the same."""
    params, obstacles, _ = gate_case(16, 32, 9)
    params = dataclasses.replace(params, max_iters=steps)

    def sim():
        s = Simulator(params, obstacles, device=CPU)
        for n in (every, steps % every, half, (steps - half) % every):
            if n:
                s._programs[n] = PROGRAMS[kind](params, obstacles, _fcinv(obstacles))
        return s

    g = sim().run_checkpointed(tmp_path / "g", every=every)
    e = sim().run_checkpointed(tmp_path / "e", every=every, route="eager")
    _bits_equal(g.f, e.f)
    _bits_equal(g.av_vels, e.av_vels)
    sim().run_checkpointed(tmp_path / "r", every=every, max_iters=half)
    r = sim().run_checkpointed(tmp_path / "r", every=every)
    _bits_equal(r.f, e.f)
    _bits_equal(r.av_vels, e.av_vels)


def test_carry_checkpoint_segments_equal_eager(tmp_path, monkeypatch):
    """The carry-resident path (a zero device budget and the x-tiled
    program): one carry for the run, a runner a segment length; an odd
    number of launches a segment, so eager segments start on both
    parities; bitwise the eager route's, resumed too."""
    params = LBMParams(64, 16, 14, 10, 0.1, 0.01, 1.85)
    obstacles = channel_box(64, 16, interior_row=9)
    monkeypatch.setattr(runtime, "hbm_budget_gib", lambda device: 0.0)
    monkeypatch.setattr(runtime, "make_program", lambda p, o, c, kernel, device, max_iters=None:
                        fused.TemporalXtStep(p, o, c, device, 4, 16, 2))
    sim = Simulator(params, obstacles, device=CPU)
    g = sim.run_checkpointed(tmp_path / "g", every=6)
    e = sim.run_checkpointed(tmp_path / "e", every=6, route="eager")
    _bits_equal(g.f, e.f)
    _bits_equal(g.av_vels, e.av_vels)
    sim.run_checkpointed(tmp_path / "r", every=6, max_iters=6)
    r = sim.run_checkpointed(tmp_path / "r", every=6)
    _bits_equal(r.f, e.f)
    _bits_equal(r.av_vels, e.av_vels)


def test_sharded_checkpoint_segments_equal_eager(tmp_path):
    """Sharded checkpointed segments, each length prepared once: the graph
    route's files the eager route's bits."""
    params, obstacles, _ = gate_case(32, 64, seed=10)
    params = dataclasses.replace(params, max_iters=10)
    sim = sharded.ShardedSimulator(params, obstacles, mesh=_mesh(2, 2), kernel="temporal",
                                   temporal_split=(4, 2))
    g = sim.run_checkpointed(str(tmp_path / "g"), every=4)
    e = sim.run_checkpointed(str(tmp_path / "e"), every=4, route="eager")
    _bits_equal(g.f, e.f)
    _bits_equal(g.av_vels, e.av_vels)


CUDA0, CUDA1 = torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.parametrize("devices, processes, plain, want", [
    ([CUDA0], 1, False, "graph"), ([CPU], 1, False, "graph"),
    ([CUDA0, CUDA0], 1, False, "graph"), ([CUDA0], 2, False, "eager"),
    ([CUDA0, CUDA1], 1, False, "eager"), ([CUDA0], 1, True, "eager"),
    ([CPU], 1, True, "graph")],
    ids=["one-card", "cpu", "two-shards-one-card", "processes", "two-cards", "plain-cuda",
         "plain-cpu"])
def test_route_by_topology(devices, processes, plain, want):
    assert graphs.choose_route(devices, processes, plain) == want


def test_route_eager_under_nan_guard_and_interpret():
    """``nan_guard`` checks after every launch: eager everywhere; the plain
    versions inside ``interpret_kernels`` on a card: eager."""
    with debugging.nan_guard():
        assert graphs.choose_route([CUDA0]) == "eager"
        assert graphs.choose_route([CPU]) == "eager"
    with debugging.interpret_kernels():
        assert graphs.choose_route([CUDA0]) == "eager"
        assert graphs.choose_route([CPU]) == "graph"


def test_simulators_name_their_route():
    params, obstacles, f0 = gate_case(16, 32, 6)
    params = dataclasses.replace(params, max_iters=4)
    sim = Simulator(params, obstacles, device=CPU)
    assert sim.launch_route() == "graph" and sim.compiled().route == "graph"
    with debugging.nan_guard():
        assert sim.launch_route() == "eager" and sim.compiled().route == "eager"
        res = sim.run(f0=f0)
    _bits_equal(res.f, sim.run(f0=f0).f)
    with pytest.raises(ValueError, match="route must be one of"):
        sim.compiled(route="scan")
    ssim = sharded.ShardedSimulator(params, obstacles, mesh=_mesh(2, None))
    assert ssim.launch_route() == "graph"
    with debugging.nan_guard():
        assert ssim.launch_route() == "eager"


class FailingCapture(graphs.Recorder):
    """A capture the CUDA runtime refuses."""

    def capturing(self):
        raise RuntimeError("operation not permitted when stream is capturing")


def test_failed_capture_raises(monkeypatch):
    """No fallback: a capture that fails raises out of ``compiled`` and
    ``prepare``, and nothing runs the eager loop in its place."""
    monkeypatch.setattr(graphs, "capture_for", lambda device: FailingCapture)
    params, obstacles, _ = gate_case(16, 32, 7)
    params = dataclasses.replace(params, max_iters=4)
    with pytest.raises(RuntimeError, match="stream is capturing"):
        Simulator(params, obstacles, device=CPU).run()
    with pytest.raises(RuntimeError, match="stream is capturing"):
        sharded.ShardedSimulator(params, obstacles, mesh=_mesh(2, None)).run()
    Simulator(params, obstacles, device=CPU).run(route="eager")  # the eager route still runs

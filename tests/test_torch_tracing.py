"""The port's spans (``lbm_tpu_torch.utils.profiling.span``) on the CPU.

Nothing is recorded, and no ``record_function`` entered, while no profiler
records (but the set-up stages, ``always``).  Under ``torch.profiler`` a
solve is one tree rooted at ``runtime.run``, a CLI call one rooted at
``cli.run``, every span is also a range of the profile, the writers count
the bytes they put on disk, and the answers are the bits of an untraced
run.  The replay's ``device_ms`` (CUDA events) is read on the card by
``benchmark/tests/test_bench_program.py``; here from stand-in events.
"""

import collections
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from lbm_tpu_torch import _native, cli, graphs, runtime
from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.geometry import channel_box, write_obstacle_file
from lbm_tpu_torch.ops import _build
from lbm_tpu_torch.runtime import Simulator
from lbm_tpu_torch.utils import profiling

PARAMS = LBMParams(48, 32, 400, 10, 0.1, 0.005, 1.85)
OBSTACLES = channel_box(48, 32)
SOLVE = {"runtime.run": None, "runtime.prepare": "runtime.run",
         "runtime.program": "runtime.prepare", "runtime.alloc": "runtime.prepare",
         "graphs.capture": "runtime.prepare", "runtime.launch": "runtime.run",
         "graphs.replay": "runtime.launch", "runtime.sync": "runtime.run",
         "runtime.readback": "runtime.run", "runtime.expand": "runtime.run"}


@pytest.fixture(autouse=True)
def no_spans_left():
    """Each test starts and ends with no spans kept, on one intra-op
    thread."""
    profiling.take_spans()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    profiling.take_spans()


def _profiled(fn):
    profiling.take_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [e.name() for e in prof.profiler.kineto_results.events()]
    return out, profiling.take_spans(), events


def _tree(spans):
    by_id = {s.id: s for s in spans}
    return {s.name: (by_id[s.parent].name if s.parent is not None else None)
            for s in spans}


def test_nothing_is_recorded_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    sim = Simulator(PARAMS, OBSTACLES, device="cpu")
    sim.run(readback="fields")
    sim.run(readback="state", route="eager")
    assert profiling.spans() == []
    with profiling.span("runtime.run") as handle:
        handle.set(bytes=1)
    assert handle is profiling.OFF and not handle and profiling.spans() == []


@pytest.mark.parametrize("launches", [4, 3, 1])
def test_a_profiled_solve_is_one_tree(monkeypatch, launches):
    """Period graphs of 2 launches: 4 launches are two replays of one
    graph, 3 one replay and a remainder graph, 1 the remainder alone."""
    monkeypatch.setattr(graphs, "PERIOD", 2)
    chunk = Simulator(PARAMS, OBSTACLES, device="cpu").program_for(launches * 200).chunk
    assert chunk == 200
    sim = Simulator(PARAMS, OBSTACLES, device="cpu")
    res, spans, events = _profiled(lambda: sim.run(max_iters=launches * 200,
                                                  readback="fields"))
    assert res.av_vels.shape == (launches * 200,)
    reps, rest = divmod(launches, 2)
    captures = [s for s in spans if s.name == "graphs.capture"]
    assert len(captures) == (reps > 0) + (rest > 0)
    assert len(spans) == len(SOLVE) + len(captures) - 1
    assert _tree(spans) == SOLVE
    (run,) = [s for s in spans if s.parent is None]
    assert {s.root for s in spans} == {run.id}
    # A solve's spans count nothing but whether its run was kept (a new
    # Simulator's first run makes it) and where its fields were
    # reconstructed (the host, off the card), and no CUDA events time a
    # replay off the card.
    counts = {"runtime.prepare": {"reused": 0}, "runtime.expand": {"device": 0}}
    assert all(s.attrs == counts.get(s.name, {})
               and s.events is None and s.device_ms is None for s in spans)
    for s in spans:
        assert run.start <= s.start <= s.end <= run.end
    # Every span is a range of the profile too, as often as it was recorded.
    for name in SOLVE:
        assert events.count(name) == sum(s.name == name for s in spans)


def test_the_eager_route_has_the_same_spans_but_the_graphs():
    sim = Simulator(PARAMS, OBSTACLES, device="cpu")
    _, spans, _ = _profiled(lambda: sim.run(readback="state", route="eager"))
    eager = {k: v for k, v in SOLVE.items()
             if not k.startswith("graphs.") and k != "runtime.expand"}
    assert _tree(spans) == eager


def test_a_second_solve_is_a_second_root_and_builds_no_program():
    """The first solve makes its run (program, buffers, capture); the
    second, of the same length, readback and route, reuses it."""
    sim = Simulator(PARAMS, OBSTACLES, device="cpu")
    _, spans, _ = _profiled(lambda: [sim.run(readback="fields") for _ in range(2)])
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["runtime.run"] * 2
    assert roots[0].id != roots[1].id
    for root, captures, reused in zip(roots, (1, 0), (0, 1)):
        names = [s.name for s in spans if s.root == root.id]
        assert names.count("graphs.capture") == captures
        (prepare,) = [s for s in spans if s.root == root.id and s.name == "runtime.prepare"]
        assert prepare.attrs == {"reused": reused}
    assert [s.name for s in spans].count("runtime.program") == 1


def test_tracing_leaves_the_answers_bitwise():
    sim = Simulator(PARAMS, OBSTACLES, device="cpu")
    plain = sim.run(readback="fields")
    traced, spans, _ = _profiled(lambda: sim.run(readback="fields"))
    assert spans
    np.testing.assert_array_equal(plain.av_vels.view(np.int32), traced.av_vels.view(np.int32))
    np.testing.assert_array_equal(plain.fields.view(np.int32), traced.fields.view(np.int32))
    state = sim.run(readback="state", route="eager")
    traced_state, _, _ = _profiled(lambda: sim.run(readback="state", route="eager"))
    np.testing.assert_array_equal(state.f.view(np.int32), traced_state.f.view(np.int32))


@pytest.mark.parametrize("where", ["cpu", "card"])
def test_the_expand_span_says_where_the_fields_were_reconstructed(where):
    """``runtime.expand`` counts ``device``: 0 where numpy reconstructed the
    fields (the CPU device, a host payload), 1 where the card's kernel did,
    whose copy of the four planes replaces the payload's readback."""
    if where == "card" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: lbm_expand_fields has no CPU mode")
    device = "cpu" if where == "cpu" else torch.device("cuda", 0)
    sim = Simulator(PARAMS, OBSTACLES, device=device)
    plain = sim.run(readback="fields")
    res, spans, _ = _profiled(lambda: sim.run(readback="fields"))
    (expand,) = [s for s in spans if s.name == "runtime.expand"]
    assert expand.attrs == {"device": int(where == "card")}
    assert _tree(spans)["runtime.expand"] == "runtime.run"
    assert ("runtime.readback" in _tree(spans)) == (where == "cpu")
    np.testing.assert_array_equal(plain.fields.view(np.int32), res.fields.view(np.int32))
    # Host payloads (the sharded route's, assembled on the host) take numpy.
    _, spans, _ = _profiled(lambda: runtime.expand_fields(
        np.zeros((3, PARAMS.ny, PARAMS.nx), np.float16), OBSTACLES, PARAMS.density))
    assert [(s.name, s.attrs) for s in spans] == [("runtime.expand", {"device": 0})]


def _case(tmp_path, steps=400):
    _native.available()  # the process's set-up stage, done before the call
    profiling.take_spans()
    PARAMS.to_file(tmp_path / "input.params")
    write_obstacle_file(tmp_path / "obstacles.dat", OBSTACLES)
    return ["run", str(tmp_path / "input.params"), str(tmp_path / "obstacles.dat"),
            "--device", "cpu", "--max-iters", str(steps), "--output-dir", str(tmp_path / "o")]


CLI = {"cli.run": None, "cli.parse": "cli.run", "cli.setup": "cli.run",
       "runtime.program": "cli.setup", "runtime.run": "cli.run",
       "cli.epilogue": "cli.run", "io.final_state": "cli.run", "io.av_vels": "cli.run"}


def test_a_profiled_cli_call_counts_what_its_writers_wrote(tmp_path, capsys):
    argv = _case(tmp_path)
    rc, spans, events = _profiled(lambda: cli.main(argv))
    assert rc == 0 and "==done==" in capsys.readouterr().out
    top = [s for s in spans if s.parent is None]
    assert [s.name for s in top] == ["cli.run"]
    assert {s.root for s in spans} == {top[0].id}
    tree = _tree(spans)
    assert {k: tree[k] for k in CLI} == CLI
    assert set(tree) == set(CLI) | set(SOLVE)
    order = [s.name for s in sorted(spans, key=lambda s: s.start) if s.name in CLI]
    assert order == ["cli.run", "cli.parse", "cli.setup", "runtime.program", "runtime.run",
                     "cli.epilogue", "io.final_state", "io.av_vels"]
    # Every value the CLI writes is a float32: none takes the C library.
    values = {"final_state.dat": 4 * PARAMS.nx * PARAMS.ny, "av_vels.dat": PARAMS.max_iters}
    for name, file in [("io.final_state", "final_state.dat"), ("io.av_vels", "av_vels.dat")]:
        (write,) = [s for s in spans if s.name == name]
        counts = {"values": values[file], "libc": 0} if _native.available() else {}
        assert write.attrs == {"bytes": (tmp_path / "o" / file).stat().st_size, **counts}
    # Each call makes its own Simulator, so its run is made, not kept; the
    # host reconstructs its fields, off the card.
    counts = {"runtime.prepare": {"reused": 0}, "runtime.expand": {"device": 0}}
    assert all(s.attrs == counts.get(s.name, {})
               for s in spans if not s.name.startswith("io."))
    for name in tree:
        assert events.count(name) == sum(s.name == name for s in spans)


def test_profile_flag_traces_the_whole_call_with_its_spans(tmp_path, capsys):
    argv = _case(tmp_path, steps=200) + ["--profile", str(tmp_path / "prof")]
    assert cli.main(argv) == 0
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert set(CLI) | set(SOLVE) <= names
    assert profiling.spans() == []  # the trace took its spans


def test_setup_stages_are_recorded_with_no_profiler(monkeypatch, tmp_path):
    """``setup.native`` and ``setup.library`` are recorded, built or
    loaded, with or without a profiler (the native I/O library stands in
    here for the kernel library, loaded with no signatures: no nvcc on the
    CPU)."""
    _native.library.cache_clear()
    monkeypatch.setattr(_native, "library_path", lambda: tmp_path / "liblbmio-test.so")
    if _native.find_compiler() is None:
        pytest.skip("no C compiler (sysconfig CC, cc): the native I/O cannot be built")
    try:
        assert _native.library() is not None
        _native.library.cache_clear()
        assert _native.library() is not None
    finally:
        _native.library.cache_clear()
    built = tmp_path / "liblbmio-test.so"

    def compile_library(out):
        shutil.copy(built, out)
        return 1.5

    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "liblbm_step-test.so")
    monkeypatch.setattr(_build, "compile_library", compile_library)
    monkeypatch.setattr(_build, "SIGNATURES", {})
    _build.load_library.__wrapped__()
    _build.load_library.__wrapped__()
    spans = profiling.take_spans()
    assert [(s.name, s.always, s.parent) for s in spans] == [
        ("setup.native", True, None)] * 2 + [("setup.library", True, None)] * 2
    assert all(s.attrs == {} for s in spans)


def test_the_package_import_is_a_setup_stage():
    code = ("import torch, time\n"
            "t0 = time.perf_counter()\n"
            "import lbm_tpu_torch\n"
            "t1 = time.perf_counter()\n"
            "from lbm_tpu_torch.utils import profiling\n"
            "(s,) = profiling.spans()\n"
            "assert (s.name, s.always, s.parent, s.root) == ('setup.import', True, None, s.id)\n"
            "assert t0 <= s.start <= s.end <= t1, (t0, s, t1)\n"
            "assert not profiling.recording()\n"
            "print('ok')\n")
    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]


def test_spans_nest_by_context_and_take_clears():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("a", n=1) as a:
            with profiling.span("b") as b:
                b.set(bytes=3)
            with profiling.span("c") as c:
                pass
        a.set(late=2)
        with profiling.span("d") as d:
            pass
    assert a and a.attrs == {"n": 1, "late": 2}
    assert (b.parent, c.parent) == (a.id, a.id)
    assert (b.root, d.root, d.parent) == (a.id, d.id, None)
    assert a.start <= b.start <= b.end <= a.end
    assert [s.name for s in profiling.spans()] == ["b", "c", "a", "d"]
    assert [s.name for s in profiling.take_spans()] == ["b", "c", "a", "d"]
    assert profiling.spans() == []


class Event:
    """What ``Span.device_ms`` asks of a pair of CUDA events."""

    def __init__(self, ms: float) -> None:
        self.ms, self.waited = ms, False

    def synchronize(self) -> None:
        self.waited = True

    def elapsed_time(self, end: "Event") -> float:
        assert end.waited, "read before the device passed the second event"
        return end.ms - self.ms


def test_device_ms_is_read_from_the_span_events_when_read():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("graphs.replay") as replay:
            pass
    assert replay.device_ms is None
    replay.events = (Event(1.0), Event(3.5))
    assert replay.device_ms == 2.5 and replay.attrs == {}


def test_kept_spans_are_capped_and_trace_takes_its_own(monkeypatch, tmp_path):
    monkeypatch.setattr(profiling, "_SPANS", collections.deque(maxlen=3))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(5):
            with profiling.span(f"s{i}"):
                pass
    assert [s.name for s in profiling.spans()] == ["s2", "s3", "s4"]
    with profiling.trace(str(tmp_path)):
        with profiling.span("inside"):
            pass
    assert profiling.spans() == []
    assert (tmp_path / "trace.json").is_file()

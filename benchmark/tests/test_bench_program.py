"""The metrics that read the program's own spans (``lbmbench/program.py``):
each read from a CPU-profiled window marked as a card run, and nothing from
a ``cpu`` run, a run with no window, or a program that records no spans."""

import time

import pytest
import torch
from conftest import TINY_PARAMS

from lbmbench import harness, program, spec, tracing
from lbm_tpu_torch import cli, graphs
from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.geometry import channel_box, write_obstacle_file
from lbm_tpu_torch.runtime import Simulator
from lbm_tpu_torch.utils import profiling

CARD = "NVIDIA H100 80GB HBM3"
NEW = ("runtime.capture_ms", "runtime.captures_per_solve", "kernels.replay_ms",
       "cli.write_mb_s", "setup.program_s")
PARAMS = LBMParams(TINY_PARAMS["nx"], TINY_PARAMS["ny"], TINY_PARAMS["maxIters"],
                   10, 0.1, 0.005, 1.85)


class Event:
    """What ``Span.device_ms`` asks of a pair of CUDA events: the second
    synchronised, then the milliseconds from the first."""

    def __init__(self, ms: float = 0.0) -> None:
        self.ms = ms

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, end: "Event") -> float:
        return end.ms - self.ms


def traced(job, jobs: int) -> list:
    """A set-up stage, then ``jobs`` jobs in a profiled ``window`` span, as
    the harness runs them; returns the harness's spans."""
    profiling.take_spans()
    with profiling.span("setup.test", always=True):
        with profiling.span("setup.inner", always=True):
            time.sleep(0.002)
    host = tracing.Spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with host.span("window"):
            for i in range(jobs):
                job(i)
    return host.items


def record(bench, cell: str, device_name: str, spans: list, jobs: int):
    return harness.RunRecord(bench.cell(cell), device_name, None, 1.0, 1.0, jobs, 0,
                             [object()] * jobs, spans=spans)


@pytest.fixture
def solve_spans(monkeypatch):
    monkeypatch.setattr(graphs, "PERIOD", 2)  # 400 steps: 2 launches of 200, one replay
    sim = Simulator(PARAMS, channel_box(PARAMS.nx, PARAMS.ny), device="cpu")
    sim.run(readback="fields")  # the program made before the window
    yield traced(lambda i: sim.run(readback="fields"), 3)
    profiling.take_spans()


def test_solve_metrics_read_the_program_spans(tiny_root, solve_spans):
    bench = spec.Spec.load(tiny_root)
    run = record(bench, "tiny.solve", CARD, solve_spans, 3)
    spans = program.in_window(run)
    assert [s.name for s in spans].count("runtime.run") == 3
    captures = program.named(spans, "graphs.capture")
    assert bench.reader("runtime.captures_per_solve")(run) == 1.0
    assert bench.reader("runtime.capture_ms")(run) == pytest.approx(
        1e3 * sum(s.seconds for s in captures) / 3)
    # A replay span carries device_ms only where CUDA events timed it.
    assert bench.reader("kernels.replay_ms")(run) is None
    for ms, replay in zip((170.0, 180.0, 190.0), program.named(spans, "graphs.replay")):
        replay.events = (Event(), Event(ms))
    assert bench.reader("kernels.replay_ms")(run) == pytest.approx(180.0)
    assert bench.reader("cli.write_mb_s")(run) is None  # no writer in a solve
    (stage,) = program.before_window(run)
    assert stage.name == "setup.test"
    assert bench.reader("setup.program_s")(run) == pytest.approx(stage.seconds)


def test_cli_metrics_read_the_writers_bytes(tiny_root, tmp_path, capsys):
    PARAMS.to_file(tmp_path / "input.params")
    write_obstacle_file(tmp_path / "obstacles.dat", channel_box(PARAMS.nx, PARAMS.ny))
    argv = ["run", str(tmp_path / "input.params"), str(tmp_path / "obstacles.dat"),
            "--device", "cpu", "--output-dir", str(tmp_path / "o")]
    assert cli.main(argv) == 0
    spans = traced(lambda i: cli.main(list(argv)), 2)
    capsys.readouterr()
    bench = spec.Spec.load(tiny_root)
    run = record(bench, "tiny.cli", CARD, spans, 2)
    writes = program.named(program.in_window(run), "io.final_state", "io.av_vels")
    assert len(writes) == 4
    size = sum(p.stat().st_size for p in (tmp_path / "o").iterdir())
    assert sum(s.attrs["bytes"] for s in writes) == 2 * size
    assert bench.reader("cli.write_mb_s")(run) == pytest.approx(
        2 * size / sum(s.seconds for s in writes) / 1e6)
    assert bench.reader("runtime.captures_per_solve")(run) == 1.0
    profiling.take_spans()


@pytest.mark.parametrize("metric", NEW)
def test_no_reading_off_the_card_or_without_spans(tiny_root, solve_spans, monkeypatch, metric):
    bench = spec.Spec.load(tiny_root)
    for replay in program.named(program.recorded(), "graphs.replay"):
        replay.events = (Event(), Event(1.0))
    read = bench.reader(metric)
    assert read(record(bench, "tiny.solve", "cpu", solve_spans, 3)) is None
    no_window = [s for s in solve_spans if s.name != "window"]
    assert read(record(bench, "tiny.solve", CARD, no_window, 3)) is None
    # An older program: its profiling module has no spans() to read.
    monkeypatch.setattr(program, "MODULE", "lbm_tpu_torch.config")
    assert read(record(bench, "tiny.solve", CARD, solve_spans, 3)) is None
    monkeypatch.setattr(program, "MODULE", "lbm_tpu_torch.no_such_module")
    assert read(record(bench, "tiny.solve", CARD, solve_spans, 3)) is None


def test_new_metrics_are_entries_that_read_program_spans():
    from conftest import REPO

    bench = spec.Spec.load(REPO)
    entries = {m["name"]: m for m in bench.bench["per_layer"]}
    for name in NEW:
        assert entries[name]["source"] == "program_span"
        assert callable(bench.reader(name))
    assert entries["setup.program_s"]["workloads"] == [w["name"] for w in
                                                       bench.bench["workloads"]]


@pytest.mark.card
def test_replay_device_ms_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device_ms is read from CUDA events")
    sim = Simulator(PARAMS, channel_box(PARAMS.nx, PARAMS.ny), device="cuda")
    sim.run(readback="fields")
    profiling.take_spans()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities):
        sim.run(readback="fields")
    spans = profiling.take_spans()
    (replay,) = program.named(spans, "graphs.replay")
    (run,) = program.named(spans, "runtime.run")
    assert 0 < replay.device_ms < 1e3 * run.seconds

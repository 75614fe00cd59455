"""``runtime.run_reuse_pct`` (``metrics/runtime.run_reuse_pct.py``): the
share of the window's solves whose compiled run was kept, from the
``reused`` count on the program's ``runtime.prepare`` spans; nothing where
the spans do not carry it (a program that compiles every run anew)."""

import pytest
import torch
from conftest import TINY_PARAMS

from lbmbench import harness, spec, tracing
from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.geometry import channel_box
from lbm_tpu_torch.runtime import Simulator
from lbm_tpu_torch.utils import profiling

CARD = "NVIDIA H100 80GB HBM3"
METRIC = "runtime.run_reuse_pct"
PARAMS = LBMParams(TINY_PARAMS["nx"], TINY_PARAMS["ny"], TINY_PARAMS["maxIters"],
                   10, 0.1, 0.005, 1.85)


def traced(job, jobs: int) -> list:
    """``jobs`` jobs inside a profiled ``window`` span; the harness's
    spans."""
    profiling.take_spans()
    host = tracing.Spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with host.span("window"):
            for _ in range(jobs):
                job()
    return host.items


def read(root, spans: list, device_name: str = CARD):
    bench = spec.Spec.load(root)
    run = harness.RunRecord(bench.cell("tiny.solve"), device_name, None, 1.0, 1.0, 2, 0,
                            [object()] * 2, spans=spans)
    value = bench.reader(METRIC)(run)
    profiling.take_spans()
    return value


def _simulator() -> Simulator:
    return Simulator(PARAMS, channel_box(PARAMS.nx, PARAMS.ny), device="cpu")


def test_solves_on_one_warm_simulator_reuse_every_run(tiny_root):
    sim = _simulator()
    sim.run(readback="fields")  # the warm job, before the window
    assert read(tiny_root, traced(lambda: sim.run(readback="fields"), 2)) == 100.0


def test_a_simulator_a_solve_reuses_none(tiny_root):
    spans = traced(lambda: _simulator().run(readback="fields"), 2)
    assert read(tiny_root, spans) == 0.0


def test_half_of_the_runs_kept(tiny_root):
    sim = _simulator()
    lengths = iter([PARAMS.max_iters, PARAMS.max_iters // 2, PARAMS.max_iters,
                    PARAMS.max_iters // 2])
    sim.run(readback="fields")
    spans = traced(lambda: sim.run(max_iters=next(lengths), readback="fields"), 4)
    # 400 kept; 200 made, 400 kept, 200 kept.
    assert read(tiny_root, spans) == pytest.approx(75.0)


@pytest.mark.parametrize("attrs", [{}, None], ids=["without-reused", "no-prepare"])
def test_nothing_without_the_count(tiny_root, attrs):
    def job():
        if attrs is not None:
            with profiling.span("runtime.prepare", **attrs):
                pass
    assert read(tiny_root, traced(job, 2)) is None


def test_nothing_off_the_card(tiny_root):
    sim = _simulator()
    sim.run(readback="fields")
    spans = traced(lambda: sim.run(readback="fields"), 2)
    assert read(tiny_root, spans, device_name="cpu") is None

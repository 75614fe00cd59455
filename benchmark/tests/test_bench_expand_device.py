"""``runtime.expand_device_pct`` (``metrics/runtime.expand_device_pct.py``):
the share of the window's solves whose fields the card reconstructed, from
the ``device`` count on the program's ``runtime.expand`` spans; nothing
where the spans do not carry it (a program that reconstructs on the host
alone).  Off the card the solves reconstruct on the host, so a span of the
card's (``device`` 1) is stood in for by a span opened here."""

import pytest
import torch
from conftest import TINY_PARAMS

from lbmbench import harness, spec, tracing
from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.geometry import channel_box
from lbm_tpu_torch.runtime import Simulator
from lbm_tpu_torch.utils import profiling

CARD = "NVIDIA H100 80GB HBM3"
METRIC = "runtime.expand_device_pct"
PARAMS = LBMParams(TINY_PARAMS["nx"], TINY_PARAMS["ny"], TINY_PARAMS["maxIters"],
                   10, 0.1, 0.005, 1.85)


def traced(job, jobs: int) -> list:
    """``jobs`` jobs inside a profiled ``window`` span; the harness's
    spans."""
    profiling.take_spans()
    host = tracing.Spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with host.span("window"):
            for i in range(jobs):
                job(i)
    return host.items


def read(root, spans: list, device_name: str = CARD):
    bench = spec.Spec.load(root)
    run = harness.RunRecord(bench.cell("tiny.solve"), device_name, None, 1.0, 1.0, 2, 0,
                            [object()] * 2, spans=spans)
    value = bench.reader(METRIC)(run)
    profiling.take_spans()
    return value


def _solver():
    sim = Simulator(PARAMS, channel_box(PARAMS.nx, PARAMS.ny), device="cpu")
    sim.run(readback="fields")  # the warm job, before the window
    return lambda i: sim.run(readback="fields")


def _on_card(i):
    with profiling.span("runtime.expand", device=1):
        pass


def test_the_card_reconstructing_every_solve_reads_100(tiny_root):
    assert read(tiny_root, traced(_on_card, 3)) == 100.0


def test_the_host_reconstructing_every_solve_reads_0(tiny_root):
    assert read(tiny_root, traced(_solver(), 2)) == 0.0


def test_a_mix_reads_the_cards_share(tiny_root):
    solve = _solver()
    # Card, host, card, card.
    spans = traced(lambda i: solve(i) if i == 1 else _on_card(i), 4)
    assert read(tiny_root, spans) == pytest.approx(75.0)


@pytest.mark.parametrize("attrs", [{}, None], ids=["without-device", "no-expand"])
def test_nothing_without_the_count(tiny_root, attrs):
    def job(i):
        if attrs is not None:
            with profiling.span("runtime.expand", **attrs):
                pass
    assert read(tiny_root, traced(job, 2)) is None


def test_nothing_off_the_card(tiny_root):
    assert read(tiny_root, traced(_solver(), 2), device_name="cpu") is None

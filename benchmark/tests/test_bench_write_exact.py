"""``cli.write_exact_pct`` (``metrics/cli.write_exact_pct.py``): the share
of the writers' values that the program formatted exactly, from the
``values`` and ``libc`` counts on its ``io.*`` spans; nothing where the
spans do not carry them (a program before the counts)."""

import pytest
import torch
from conftest import REPO, TINY_PARAMS

from lbmbench import harness, spec, tracing
from lbm_tpu_torch import _native, cli
from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.geometry import channel_box, write_obstacle_file
from lbm_tpu_torch.utils import profiling

CARD = "NVIDIA H100 80GB HBM3"
METRIC = "cli.write_exact_pct"


def traced(job) -> list:
    """``job`` inside a profiled ``window`` span; the harness's spans."""
    profiling.take_spans()
    host = tracing.Spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with host.span("window"):
            job()
    return host.items


def writes(*counts: dict):
    """A job whose writer spans, final_state then av_vels, carry
    ``counts``."""
    def job():
        for i, c in enumerate(counts):
            with profiling.span(("io.final_state", "io.av_vels")[i % 2]) as span:
                span.set(**c)
    return job


def read(root, cell: str, spans: list, device_name: str = CARD):
    bench = spec.Spec.load(root)
    run = harness.RunRecord(bench.cell(cell), device_name, None, 1.0, 1.0, 1, 0, [object()],
                            spans=spans)
    value = bench.reader(METRIC)(run)
    profiling.take_spans()
    return value


@pytest.mark.parametrize("counts, share", [
    (({"bytes": 10, "values": 8, "libc": 0}, {"bytes": 4, "values": 2, "libc": 0}), 100.0),
    (({"bytes": 10, "values": 8, "libc": 2}, {"bytes": 4, "values": 2, "libc": 0}), 80.0),
    (({"bytes": 10, "values": 8, "libc": 8}, {"bytes": 4, "values": 2, "libc": 2}), 0.0),
], ids=["exact", "mixed", "libc"])
def test_the_share_of_exact_values(counts, share):
    assert read(REPO, "c256.cli", traced(writes(*counts))) == pytest.approx(share)


@pytest.mark.parametrize("counts", [
    ({"bytes": 10}, {"bytes": 4}),
    ({"bytes": 10, "values": 8, "libc": 0}, {"bytes": 4}),
    ({"bytes": 0, "values": 0, "libc": 0}, {"bytes": 0, "values": 0, "libc": 0}),
    (),
], ids=["bytes-only", "one-without", "no-values", "no-writes"])
def test_nothing_without_counts(counts):
    assert read(REPO, "c256.cli", traced(writes(*counts))) is None


def test_nothing_off_the_card():
    spans = traced(writes({"bytes": 10, "values": 8, "libc": 0}))
    assert read(REPO, "c256.cli", spans, device_name="cpu") is None


def test_a_cli_run_formats_every_value_exactly(tiny_root, tmp_path, capsys):
    if not _native.available():
        pytest.skip("the native writers could not be built here")
    params = LBMParams(TINY_PARAMS["nx"], TINY_PARAMS["ny"], TINY_PARAMS["maxIters"],
                       10, 0.1, 0.005, 1.85)
    params.to_file(tmp_path / "input.params")
    write_obstacle_file(tmp_path / "obstacles.dat", channel_box(params.nx, params.ny))
    argv = ["run", str(tmp_path / "input.params"), str(tmp_path / "obstacles.dat"),
            "--device", "cpu", "--output-dir", str(tmp_path / "o")]
    spans = traced(lambda: cli.main(argv))
    capsys.readouterr()
    assert read(tiny_root, "tiny.cli", spans) == 100.0


def test_the_entry_reads_program_spans_in_the_cli_cell():
    bench = spec.Spec.load(REPO)
    (entry,) = [m for m in bench.bench["per_layer"] if m["name"] == METRIC]
    assert entry == {"name": METRIC, "unit": "%", "better": "higher",
                     "source": "program_span",
                     "layer": "CLI and writers: cli.py, io.py, _native/lbmio.c",
                     "moves": "cli_run_s", "workloads": ["c256.cli"]}
    assert METRIC in [m["name"] for m in bench.metrics("c256.cli", True)]

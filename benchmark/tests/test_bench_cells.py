"""Whole runs of the tiny cells on the CPU (the program's plain versions):
the last line's keys, the traced run's metrics, what the check compares,
and the refusals: no card, no program, a program found outside the
checkout."""

import json
import subprocess
import sys

import pytest
import torch
from conftest import BENCH, REPO, last_line, run_cell

ARGS = ["--seed", "3141592653589", "--seconds", "0.05"]


@pytest.mark.parametrize("traffic", ["solve", "cli"])
def test_last_line_keys(tiny_root, capsys, traffic):
    assert run_cell(tiny_root, ["--workload", f"tiny.{traffic}", *ARGS, "--trace", "0"]) == 0
    line = last_line(capsys)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    e2e = {"solve": {"mlups", "setup_s"}, "cli": {"cli_run_s", "setup_s"}}[traffic]
    assert set(line["metrics"]) == e2e
    for metric in line["metrics"].values():
        assert set(metric) == {"value", "unit"} and metric["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for shown in line["checks"].values():
        assert set(shown) == {"value", "limit"} and shown["value"] <= shown["limit"]


@pytest.mark.parametrize("traffic, names", [
    ("solve", {"runtime.prepare_ms", "runtime.expand_ms"}),
    ("cli", {"cli.write_s", "cli.pre_solve_s"}),
])
def test_traced_run_reports_span_metrics(tiny_root, capsys, traffic, names):
    # On the CPU the profiler records no device: the device's metrics are
    # left out, the spans' are read.
    assert run_cell(tiny_root, ["--workload", f"tiny.{traffic}", *ARGS, "--trace", "1"]) == 0
    line = last_line(capsys)
    assert set(line["metrics"]) == names
    assert list(line)[-1] == "checks"


def test_compared_numbers_are_the_last_lines_of_stderr(tiny_root, capsys):
    run_cell(tiny_root, ["--workload", "tiny.cli", *ARGS, "--trace", "0"])
    err = capsys.readouterr().err.strip().splitlines()
    limits = json.loads((tiny_root / "benchmark/checks/tiny.cli.json").read_text())["limits"]
    assert [line.split(":")[0] for line in err[-len(limits):]] == [f"check {k}" for k in limits]


def test_no_card_fails_without_a_result(tiny_root, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run_cell(tiny_root, ["--workload", "tiny.solve", *ARGS], card=True) != 0
    assert capsys.readouterr().out == ""


def test_benchmark_alone_fails_without_a_result(tiny_root, capsys):
    # A checkout holding only BENCHMARK.json and the benchmark's folder.
    assert run_cell(tiny_root, ["--workload", "tiny.solve", *ARGS], port_root=tiny_root) != 0
    assert capsys.readouterr().out == ""


def test_run_py_in_a_bare_checkout_exits_nonzero(tiny_root):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "tiny.solve",
                           *ARGS], cwd=tiny_root, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_loaded_modules_have_no_jax_top_level_name(tiny_root):
    script = f"""
import json, pathlib, sys, time
sys.path.insert(0, {str(BENCH)!r})
from lbmbench import harness
rc = harness.main({["--workload", "tiny.cli", *ARGS]!r}, started=time.perf_counter(),
                  root=pathlib.Path({str(tiny_root)!r}), port_root=pathlib.Path({str(REPO)!r}),
                  card=False)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
sys.exit(rc)
"""
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "lbm_tpu_torch" in top and "lbmbench" in top
    assert not top & {"jax", "jaxlib", "flax", "lbm_tpu"}


def test_forbidden_names_compare_whole(monkeypatch):
    from lbmbench import harness

    monkeypatch.setitem(sys.modules, "lbm_tpu_torch_extra", sys)
    assert "lbm_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "lbm_tpu.config", sys)
    assert harness.forbidden_modules() == ["lbm_tpu"]


@pytest.mark.card
def test_each_cell_runs_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for workload in bench["workloads"]:
        proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                               workload["name"], "--seed", "2147483659", "--seconds", "2",
                               "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                              timeout=360)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True

"""Finding a configuration, a traffic mix, a check and a metric's reader by
name, in the benchmark as committed and in a copy with a cell added as
data only."""

import json

import pytest
from conftest import REPO

from lbmbench import spec

CONTRACT_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                 "per_layer"}


def test_every_name_in_benchmark_json_is_found():
    bench = spec.Spec.load(REPO)
    assert set(bench.bench) == CONTRACT_KEYS
    for workload in bench.bench["workloads"]:
        cell = bench.cell(workload["name"])
        assert cell.config["name"] == workload["config"]
        assert cell.traffic["entry"] in ("solve", "cli")
        assert cell.reference.is_file()
        assert cell.check["limits"]
        for trace in (False, True):
            assert bench.metrics(cell.name, trace), (cell.name, trace)
    for metric in bench.bench["end_to_end"] + bench.bench["per_layer"]:
        assert callable(bench.reader(metric["name"]))
    assert bench.peaks("NVIDIA H100 80GB HBM3")["fp32_flop_per_s"] == 67e12
    assert bench.peaks("some other card") is None


def test_configs_match_their_entries():
    bench = spec.Spec.load(REPO)
    for entry in bench.bench["configs"]:
        config = json.loads((REPO / entry["file"]).read_text())
        assert config["name"] == entry["name"]
        assert config["reduced"] == entry["reduced"] == []
        assert len(entry["source"]) <= 200 and len(config["source"]) <= 200


def test_metrics_moves_and_workloads_name_real_entries():
    bench = spec.Spec.load(REPO).bench
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for metric in bench["per_layer"]:
        moved = e2e[metric["moves"]]
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))
    for metric in bench["end_to_end"]:
        assert set(metric.get("workloads", cells)) <= cells


def test_a_cell_added_as_data_is_found(tiny_root):
    bench = spec.Spec.load(tiny_root)
    cell = bench.cell("tiny.solve")
    assert cell.config["params"]["nx"] == 48
    assert [m["name"] for m in bench.metrics("tiny.solve", False)] == ["mlups", "setup_s"]
    assert "cli.write_s" in [m["name"] for m in bench.metrics("tiny.cli", True)]
    assert "cli.write_s" not in [m["name"] for m in bench.metrics("tiny.solve", True)]


def test_a_metric_added_as_a_file_is_read(tiny_root):
    (tiny_root / "benchmark" / "metrics" / "jobs_done.py").write_text(
        "def read(run):\n    return len(run.jobs)\n")
    assert spec.Spec.load(tiny_root).reader("jobs_done")(type("R", (), {"jobs": [1, 2]})) == 2


@pytest.mark.parametrize("name", ["nope.solve", "../c256", "a b"])
def test_unknown_or_malformed_names_are_refused(name):
    with pytest.raises(spec.SpecError):
        spec.Spec.load(REPO).cell(name)

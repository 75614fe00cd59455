"""CPU tests of the benchmark's harness (run from the checkout's root:
``python -m pytest benchmark/tests``).  Tests that need a CUDA card are
marked ``card`` and skip, deciding inside the test, where torch sees none.

``tiny_root`` is a checkout with the benchmark's folder copied and a small
configuration of its own added as data (``tiny``, 32 x 48 cells, 400
steps, the c256 case's params): cells ``tiny.solve`` and ``tiny.cli``,
which run the program's plain versions on the CPU.
"""

import json
import pathlib
import shutil
import sys
import time

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
REPO = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(REPO))

TINY_PARAMS = {"nx": 48, "ny": 32, "maxIters": 400}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


def make_tiny_root(dest: pathlib.Path, limits: dict | None = None) -> pathlib.Path:
    shutil.copytree(BENCH, dest / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    config = json.loads((BENCH / "configs" / "c256.json").read_text())
    config["name"] = "tiny"
    config["params"].update(TINY_PARAMS)
    (dest / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(config))
    bench["configs"].append({"name": "tiny", "source": "tests", "reduced": [], "why": "tests",
                             "file": "benchmark/configs/tiny.json"})
    for traffic in ("solve", "cli"):
        name = f"tiny.{traffic}"
        bench["workloads"].append({"name": name, "config": "tiny", "traffic": traffic,
                                   "chips": 1, "why": "tests"})
        check = json.loads((BENCH / "checks" / f"c256.{traffic}.json").read_text())
        if limits:
            check["limits"].update(limits)
        (dest / "benchmark" / "checks" / f"{name}.json").write_text(json.dumps(check))
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if any(w.endswith(f".{traffic}") for w in metric.get("workloads", [])):
                metric["workloads"].append(name)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


def run_cell(root, argv, card=False, port_root=REPO):
    """``harness.main`` on ``root``'s BENCHMARK.json; returns the exit code."""
    from lbmbench import harness

    return harness.main(argv, started=time.perf_counter(), root=root, port_root=port_root,
                        card=card)


def last_line(capsys) -> dict:
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])

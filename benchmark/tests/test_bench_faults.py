"""``correct`` comes out false when the timed path is broken underneath, and
the lower-precision control fails the limits (at a size a test run holds;
on the card at the cells' own sizes, ``benchmark/calibrate.py``).

Faults that these cells can have: a step that returns its state unchanged,
and an answer altered where it is produced (the fields payload, or a line
of a file that the CLI writes).  The cells run no batch and no exchange
between chips, so those two faults have no place here.
"""

import json
import sys

import numpy as np
import pytest
import torch
from conftest import BENCH, last_line, run_cell

import lbm_tpu_torch.cli as cli
import lbm_tpu_torch.runtime as runtime
from lbmbench import cases, compare, spec
from lbmbench import traffic as traffic_mod

ARGS = ["--seed", "2718281828459", "--seconds", "0.05", "--trace", "0"]


def unchanged_state(monkeypatch):
    """Every launch of the run leaves f as it found it, and reports no speed."""
    compiled = runtime.Simulator.compiled

    def frozen(self, *args, **kwargs):
        fn = compiled(self, *args, **kwargs)

        def run(f0=None):
            out, av = fn(f0)
            f = torch.as_tensor(f0) if f0 is not None else self._uniform()
            return self._fields(f, torch.as_tensor(~self.obstacles)), torch.zeros_like(av)

        run.route, run.buffers = fn.route, fn.buffers
        return run

    monkeypatch.setattr(runtime.Simulator, "compiled", frozen)


def altered_fields(monkeypatch):
    expand = runtime.expand_fields

    def altered(raw, obstacles, density):
        out = expand(raw, obstacles, density)
        y, x = np.argwhere(~np.asarray(obstacles, bool))[len(obstacles) // 2]
        out[0, y, x] += 0.05 * np.abs(out[2]).max()  # one cell's u_x
        return out

    monkeypatch.setattr(runtime, "expand_fields", altered)


def altered_av_line(monkeypatch):
    write = cli.write_av_vels

    def altered(path, av):
        av = np.array(av, copy=True)
        av[len(av) // 2] *= 1.05
        write(path, av)

    monkeypatch.setattr(cli, "write_av_vels", altered)


@pytest.mark.parametrize("traffic, fault", [
    ("solve", unchanged_state), ("cli", unchanged_state),
    ("solve", altered_fields), ("cli", altered_fields), ("cli", altered_av_line),
])
def test_a_broken_timed_path_is_not_correct(tiny_root, capsys, monkeypatch, traffic, fault):
    fault(monkeypatch)
    assert run_cell(tiny_root, ["--workload", f"tiny.{traffic}", *ARGS]) == 0
    line = last_line(capsys)
    assert line["correct"] is False
    assert any(s["value"] is None or s["value"] > s["limit"] for s in line["checks"].values())


def test_the_sound_path_is_correct(tiny_root, capsys):
    assert run_cell(tiny_root, ["--workload", "tiny.solve", *ARGS]) == 0
    assert last_line(capsys)["correct"] is True


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("cell", ["c1024.solve", "c256.solve", "c256.cli"])
def test_bfloat16_control_fails_the_cells_limits(tiny_root, seed, cell):
    """The reference in bfloat16 in the program's place, against float32,
    from the seed's data of the tiny configuration, held to each cell's
    own limits."""
    limits = json.loads((BENCH / "checks" / f"{cell}.json").read_text())["limits"]
    bench = spec.Spec.load(tiny_root)
    traffic_name = cell.split(".")[1]
    tiny = bench.cell(f"tiny.{traffic_name}")
    ref = spec.load_module(tiny.reference)
    p = tiny.config["params"]
    if traffic_name == "cli":
        blocked = cases.obstacles(tiny.config, tiny.traffic, seed)
        f0 = cases.initial_state(tiny.config, {"amplitude": 0.0}, seed, 0, "cpu")
    else:
        blocked = cases.published_walls(tiny.config)
        f0 = cases.initial_state(tiny.config, tiny.traffic, seed, 0, "cpu")
    answers = {}
    for dtype in (torch.float32, torch.bfloat16):
        f, av = ref.Solver(p, blocked, 1, dtype, "cpu").run(f0[None], p["maxIters"])
        answers[dtype] = (av[0], ref.fields(f[0], blocked, p["density"]))
    numbers = compare.solve_numbers([answers[torch.bfloat16]], [answers[torch.float32]],
                                    p["density"])
    ok, _ = compare.verdict(numbers, {k: v for k, v in limits.items() if k in numbers})
    assert not ok, numbers


@pytest.mark.parametrize("storage", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("cell", ["c1024.solve", "c256.solve", "c256.cli"])
def test_program_16bit_control_fails_the_cells_limits(tiny_root, cell, storage):
    """The program's own 16-bit storage path (its plain version on the CPU)
    in the program's place, from the tiny configuration's seeded data, held
    to each cell's limits: the control whose readings set the upper ends."""
    calibrate = spec.load_module(BENCH / "calibrate.py")
    limits = json.loads((BENCH / "checks" / f"{cell}.json").read_text())["limits"]
    traffic_name = cell.split(".")[1]
    bench = spec.Spec.load(tiny_root)
    t = traffic_mod.make(bench.cell(f"tiny.{traffic_name}"), sys.modules["lbm_tpu_torch"],
                         7, torch.device("cpu"), tiny_root / ".bench_work" / "control")
    if traffic_name == "cli":
        t.obstacles = cases.obstacles(t.config, t.traffic, 7)
        f0 = cases.initial_state(t.config, {"amplitude": 0.0}, 7, 0, "cpu")
    else:
        t.obstacles = cases.published_walls(t.config)
        f0 = cases.initial_state(t.config, t.traffic, 7, 0, "cpu")
    ref_fields, ref_av = t.reference(f0[None], torch.float32, t.obstacles)
    low = calibrate.program16(t, sys.modules["lbm_tpu_torch"], f0, storage)
    numbers = calibrate.control_numbers(t, (ref_av[0], ref_fields[0]), low)
    ok, _ = compare.verdict(numbers, {k: v for k, v in limits.items() if k in numbers})
    assert not ok, numbers

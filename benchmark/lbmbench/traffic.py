"""The one generator of jobs, driven by a traffic file's parameters.

Every mix is a closed loop: one job after another, as a user runs them.
``traffic["entry"]`` says which entry of the program a job calls:

- ``"solve"``: ``Simulator.run(f0=<seeded state>, readback="fields")`` of
  the configuration's full case, on one ``Simulator`` made in set-up; the
  job's initial state comes from ``--seed`` and the job's number
  (:func:`cases.initial_state`, ``traffic["amplitude"]``);
- ``"cli"``: ``lbm_tpu_torch.cli.main(["run", <params>, <obstacles>,
  "--output-dir", <dir>])`` in the warm process,
  on the two files written in set-up (the obstacles from ``--seed``,
  ``traffic["extra_obstacles"]``), its standard output into a file.

A job returns what the check compares; :meth:`check` recomputes the
sampled answer with the plain reference, once the program is released.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import pathlib
import shutil

import numpy as np
import torch

from lbmbench import cases, compare, spec


@dataclasses.dataclass
class Job:
    index: int
    updates: int        # cell updates the job made
    answer: object      # what the check compares (solve: (av, fields))


def make(cell: spec.Cell, port, seed: int, device: torch.device,
         work_dir: pathlib.Path):
    entries = {"solve": SolveTraffic, "cli": CliTraffic}
    entry = cell.traffic["entry"]
    if entry not in entries:
        raise spec.SpecError(f"unknown traffic entry {entry!r}")
    return entries[entry](cell, port, seed, device, pathlib.Path(work_dir))


class _Traffic:
    entry = ""

    def __init__(self, cell, port, seed, device, work_dir) -> None:
        self.cell, self.port, self.seed, self.device = cell, port, seed, device
        self.work_dir = work_dir
        self.config, self.traffic = cell.config, cell.traffic
        self.params = self.config["params"]
        self.updates = self.params["nx"] * self.params["ny"] * self.params["maxIters"]

    def reference(self, f0: torch.Tensor, dtype: torch.dtype, obstacles: np.ndarray):
        """The plain reference from the states ``f0[B, 9, ny, nx]``: the final
        fields of each and the av series, ``([fields], av[B, steps])``."""
        ref = spec.load_module(self.cell.reference)
        solver = ref.Solver(self.params, obstacles, f0.shape[0], dtype, self.device)
        f, av = solver.run(f0, self.params["maxIters"])
        return [ref.fields(f[b], obstacles, self.params["density"])
                for b in range(f.shape[0])], av

    def release(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


class SolveTraffic(_Traffic):
    entry = "solve"

    def setup(self) -> None:
        runtime, config = self.port.runtime, self.port.config
        p = self.params
        self.obstacles = cases.published_walls(self.config)
        self.sim = runtime.Simulator(
            config.LBMParams(p["nx"], p["ny"], p["maxIters"], p["reynolds_dim"],
                             p["density"], p["accel"], p["omega"]),
            self.obstacles, device=self.device)
        self.f0 = self.state(-1)
        self.job(-1)  # warm: the case's own shapes, every kernel built

    def state(self, index: int, out: torch.Tensor | None = None) -> torch.Tensor:
        return cases.initial_state(self.config, self.traffic, self.seed, index, self.device,
                                   out=out)

    def job(self, index: int) -> Job:
        res = self.sim.run(f0=self.state(index, out=self.f0), readback="fields")
        return Job(index, self.updates, (res.av_vels, res.fields))

    def release(self) -> None:
        self.sim = self.f0 = None
        super().release()

    def check(self, jobs: list[Job]) -> dict:
        """The numbers of one job of the window, drawn from the seed."""
        job = jobs[np.random.default_rng(cases.seed_words(self.seed, 3)).integers(len(jobs))]
        ref_fields, ref_av = self.reference(self.state(job.index)[None], torch.float32,
                                            self.obstacles)
        return compare.solve_numbers([job.answer], [(ref_av[0], ref_fields[0])],
                                     self.params["density"])


class CliTraffic(_Traffic):
    entry = "cli"

    def setup(self) -> None:
        if self.work_dir.exists():
            shutil.rmtree(self.work_dir)
        self.out_dir = self.work_dir / "out"
        self.out_dir.mkdir(parents=True)
        self.params_path = self.work_dir / "input.params"
        self.obstacles_path = self.work_dir / "obstacles.dat"
        self.obstacles = cases.obstacles(self.config, self.traffic, self.seed)
        cases.write_params(self.params_path, self.config)
        cases.write_obstacles(self.obstacles_path, self.obstacles)
        self.argv = ["run", str(self.params_path), str(self.obstacles_path),
                     "--output-dir", str(self.out_dir)]
        if self.device.type == "cpu":
            self.argv += ["--device", "cpu"]
        self.stdout_path = self.work_dir / "warm_stdout.txt"
        self.job(-1)  # warm: the parse, the program, both writers
        self.stdout_path = self.work_dir / "stdout.txt"

    def job(self, index: int) -> Job:
        with open(self.stdout_path, "a") as out, contextlib.redirect_stdout(out):
            rc = self.port.cli.main(list(self.argv))
        if rc != 0:
            raise RuntimeError(f"cli run exited {rc}")
        return Job(index, self.updates, None)

    def check(self, jobs: list[Job]) -> dict:
        """The numbers of the files on disk, written by the last run, and of
        the epilogues that every run printed."""
        f0 = cases.initial_state(self.config, {"amplitude": 0.0}, self.seed, 0, self.device)
        ref_fields, ref_av = self.reference(f0[None], torch.float32, self.obstacles)
        stdout = self.stdout_path.read_text() if self.stdout_path.exists() else ""
        return compare.cli_numbers(self.out_dir, stdout, len(jobs), self.params,
                                   self.obstacles, ref_av[0], ref_fields[0])

"""Find what a cell needs by name: ``BENCHMARK.json`` at the checkout's root,
and the files of the benchmark's folder (the first of its ``paths``):

- ``configs/<config>.json`` (the ``file`` of the configuration's entry),
  whose ``reference`` names ``references/<reference>.py``;
- ``traffic/<traffic>.json``: the parameters of a traffic mix;
- ``checks/<cell>.json``: the limits of the comparison that decides
  ``correct``;
- ``metrics/<metric>.py``: a reader with ``read(run) -> float | None``;
- ``launches/<wrapper>.json``: the CUDA kernels behind one counter of
  ``lbm_tpu_torch.ops.fused.LAUNCHES``;
- ``peaks.json``: published peaks by device name.

A later cell, configuration or metric is a new file and a new entry here;
nothing in this module names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


class SpecError(ValueError):
    """A name that ``BENCHMARK.json`` or the benchmark's folder lacks."""


def _name(value: str) -> str:
    if not isinstance(value, str) or not NAME.fullmatch(value):
        raise SpecError(f"not a valid name: {value!r}")
    return value


def _read_json(path: pathlib.Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise SpecError(f"missing file {path}") from None


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with everything it names, loaded."""

    name: str
    chips: int
    config: dict        # the configuration's file
    traffic: dict       # traffic/<traffic>.json
    check: dict         # checks/<cell>.json
    reference: pathlib.Path


@dataclasses.dataclass(frozen=True)
class Spec:
    root: pathlib.Path      # the checkout
    bench: dict             # BENCHMARK.json

    @classmethod
    def load(cls, root: pathlib.Path) -> "Spec":
        root = pathlib.Path(root)
        return cls(root, _read_json(root / "BENCHMARK.json"))

    @property
    def folder(self) -> pathlib.Path:
        """The benchmark's own folder: the first of ``paths``."""
        return self.root / self.bench["paths"][0]

    def _entry(self, key: str, name: str) -> dict:
        for entry in self.bench[key]:
            if entry["name"] == name:
                return entry
        known = ", ".join(e["name"] for e in self.bench[key])
        raise SpecError(f"no {key} entry named {name!r} (known: {known})")

    def cell(self, name: str) -> Cell:
        workload = self._entry("workloads", _name(name))
        config_entry = self._entry("configs", _name(workload["config"]))
        config = _read_json(self.root / config_entry["file"])
        traffic_name = _name(workload["traffic"])
        return Cell(
            name=name,
            chips=int(workload["chips"]),
            config=config,
            traffic=_read_json(self.folder / "traffic" / f"{traffic_name}.json"),
            check=_read_json(self.folder / "checks" / f"{name}.json"),
            reference=self.folder / "references" / f"{_name(config['reference'])}.py",
        )

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The metrics a run of ``cell`` reports: its end-to-end metrics
        with ``trace`` off, its per-layer metrics with it on."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """The ``read(run)`` function of ``metrics/<metric>.py``."""
        return load_module(self.folder / "metrics" / f"{_name(metric)}.py").read

    def launches(self) -> dict[str, dict]:
        """``{wrapper: {"kernel": name, "then": [names]}}`` from
        ``launches/*.json``: the kernels each launch counter stands for."""
        return {p.stem: _read_json(p) for p in sorted((self.folder / "launches").glob("*.json"))}

    def peaks(self, device_name: str) -> dict | None:
        """The published peaks of a device, or None for a device the table
        does not hold."""
        return _read_json(self.folder / "peaks.json")["devices"].get(device_name)


def load_module(path: pathlib.Path):
    """Import one file of the benchmark's folder by its path."""
    path = pathlib.Path(path)
    if not path.is_file():
        raise SpecError(f"missing file {path}")
    key = "lbmbench_file_" + re.sub(r"\W", "_", str(path))
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module

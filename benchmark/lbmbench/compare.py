"""The numbers that decide ``correct``: the program's answers against the
plain reference's, each number held to its limit in ``checks/<cell>.json``.

- ``av_gap``: the widest relative gap of a step's mean speed, over every
  step, as the coursework's checker reads ``av_vels.dat``;
- ``u_gap``: the widest gap of u_x, u_y or |u| over every cell, as a share
  of the reference's largest |u|;
- ``p_gap``: the widest gap of the pressure over every cell, as a share of
  the reference's largest departure from density/3 (the pressure of fluid
  at rest), so that the number sees the flow and not the constant;
- ``layout_errors`` (``cli``): lines of the two files whose step, x, y or
  obstacle column is not the expected one, lines missing or extra, and
  runs that printed no Reynolds number (the end of the run's epilogue).

A non-finite number is None and fails.
"""

from __future__ import annotations

import math
import pathlib
import re

import numpy as np


def _finite(value: float) -> float | None:
    return float(value) if math.isfinite(value) else None


def _widest(gap: np.ndarray) -> float:
    """The largest entry, or inf where any entry is not finite."""
    return float(np.max(gap)) if np.all(np.isfinite(gap)) else math.inf


def av_gap(av: np.ndarray, ref: np.ndarray) -> float:
    av, ref = np.asarray(av, np.float64), np.asarray(ref, np.float64)
    if av.shape != ref.shape:
        return math.inf
    return _widest(np.abs(av - ref) / np.abs(ref))


def field_gaps(fields: np.ndarray, ref: np.ndarray, density: float) -> dict[str, float]:
    """``u_gap`` and ``p_gap`` of ``[u_x, u_y, |u|, pressure]`` stacks."""
    fields, ref = np.asarray(fields, np.float64), np.asarray(ref, np.float64)
    if fields.shape != ref.shape:
        return {"u_gap": math.inf, "p_gap": math.inf}
    u_scale = np.max(np.abs(ref[2]))
    p_scale = np.max(np.abs(ref[3] - density / 3.0))
    return {"u_gap": _widest(np.abs(fields[:3] - ref[:3]) / u_scale),
            "p_gap": _widest(np.abs(fields[3] - ref[3]) / p_scale)}


def solve_numbers(answers: list[tuple[np.ndarray, np.ndarray]],
                  refs: list[tuple[np.ndarray, np.ndarray]], density: float) -> dict:
    """The widest of each number over the sampled answers ``(av, fields)``."""
    out = {"av_gap": 0.0, "u_gap": 0.0, "p_gap": 0.0}
    for (av, fields), (ref_av, ref_fields) in zip(answers, refs, strict=True):
        out["av_gap"] = max(out["av_gap"], av_gap(av, ref_av))
        for key, value in field_gaps(fields, ref_fields, density).items():
            out[key] = max(out[key], value)
    return out


REYNOLDS = re.compile(r"^Reynolds number:\s*(\S+)\s*$", re.M)


def cli_numbers(out_dir: pathlib.Path, stdout: str, runs: int, params: dict,
                obstacles: np.ndarray, ref_av: np.ndarray, ref_fields: np.ndarray) -> dict:
    """The numbers of the files a ``run`` wrote into ``out_dir``, and the
    epilogues that ``runs`` runs printed into ``stdout``."""
    ny, nx = obstacles.shape
    errors = 0
    av, steps = [], ref_av.shape[0]
    for i, line in enumerate((out_dir / "av_vels.dat").read_text().splitlines()):
        step, sep, value = line.partition(":")
        errors += int(not sep or step != str(i))
        av.append(float(value) if sep else math.nan)
    errors += abs(len(av) - steps)
    table = np.loadtxt(out_dir / "final_state.dat", ndmin=2)
    errors += abs(table.shape[0] - ny * nx)
    m = min(table.shape[0], ny * nx)
    ys, xs = np.divmod(np.arange(m), nx)
    expected = (xs, ys, np.asarray(obstacles, int).ravel()[:m])
    for column, want in zip((0, 1, 6), expected):
        errors += int(np.count_nonzero(table[:m, column] != want))
    out = {"av_gap": av_gap(np.array(av), ref_av)}
    if table.shape[0] == ny * nx:
        fields = table[:, 2:6].T.reshape(4, ny, nx)
        out.update(field_gaps(fields, ref_fields, params["density"]))
    else:
        out.update(u_gap=math.inf, p_gap=math.inf)
    errors += abs(runs - len(REYNOLDS.findall(stdout)))
    out["layout_errors"] = errors
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Whether every number is within its limit, and ``{name: {"value",
    "limit"}}`` in the order of ``limits``."""
    shown, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        value = _finite(value) if isinstance(value, float) else value
        shown[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and value <= limit
    return ok, shown

"""A configuration's grid, obstacles and seeded data, made by the benchmark
itself and handed alike to the program and to the reference.

The seed makes data, never shapes: the grid, the steps, the params and the
published walls are the configuration's.  ``solve`` traffic takes the seed
into each job's initial state (:func:`initial_state`); ``cli`` traffic,
whose entry reads only its two files, into obstacle cells added beside
the published walls (:func:`obstacles`).
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

WEIGHTS = (4.0 / 9.0,) + (1.0 / 9.0,) * 4 + (1.0 / 36.0,) * 4


def seed_words(*keys: int) -> int:
    """A 63-bit seed from a run's ``--seed`` and further keys (any size)."""
    return int(np.random.SeedSequence([int(k) % 2**64 for k in keys])
               .generate_state(1, dtype=np.uint64)[0] >> 1)


def published_walls(config: dict) -> np.ndarray:
    """The configuration's obstacle mask, ``[ny, nx]`` bool, True = blocked:
    the ``channel_box`` family of the coursework's ``obstacles_*.dat``."""
    p, spec = config["params"], config["obstacles"]
    if spec["family"] != "channel_box":
        raise ValueError(f"unknown obstacle family {spec['family']!r}")
    ny, nx = p["ny"], p["nx"]
    mask = np.zeros((ny, nx), dtype=bool)
    if spec["side_walls"]:
        mask[:, 0] = mask[:, nx - 1] = True
    if spec["top_bottom_walls"]:
        mask[0, :] = mask[ny - 1, :] = True
    if spec.get("interior_row") is not None:
        mask[spec["interior_row"], :] = True
    if spec.get("interior_col") is not None:
        mask[:, spec["interior_col"]] = True
    return mask


def obstacles(config: dict, traffic: dict, seed: int) -> np.ndarray:
    """The published walls plus ``traffic["extra_obstacles"]`` distinct
    cells drawn from the seed among the open interior cells (none where
    the traffic adds none)."""
    mask = published_walls(config)
    count = int(traffic.get("extra_obstacles", 0))
    if count:
        ny, nx = mask.shape
        open_cells = np.flatnonzero(~mask[1:ny - 1, 1:nx - 1].ravel())
        rng = np.random.default_rng(seed_words(seed, 1))
        picked = rng.choice(open_cells, size=count, replace=False)
        ys, xs = np.divmod(picked, nx - 2)
        mask[ys + 1, xs + 1] = True
    return mask


def initial_state(config: dict, traffic: dict, seed: int, job: int, device,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Job ``job``'s initial state ``[9, ny, nx]`` float32, made on
    ``device`` from a generator there: ``w_k density (1 + a xi)`` with xi
    uniform in [-1, 1) for every population of every cell and ``a =
    traffic["amplitude"]`` (< 1, so every population stays positive).
    ``out``, where given, is filled in place: a window's jobs then allocate
    nothing on the device for their states."""
    p = config["params"]
    amplitude = float(traffic["amplitude"])
    if not 0.0 <= amplitude < 1.0:
        raise ValueError(f"amplitude must be in [0, 1), got {amplitude}")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_words(seed, 2, job))
    if out is None:
        out = torch.empty((9, p["ny"], p["nx"]), device=device, dtype=torch.float32)
    torch.rand(out.shape, generator=gen, device=device, dtype=torch.float32, out=out)
    w = torch.tensor(WEIGHTS, dtype=torch.float64) * p["density"]
    w = w.to(torch.float32).to(device)[:, None, None]
    return out.mul_(2.0 * amplitude).add_(1.0 - amplitude).mul_(w)


def write_params(path: pathlib.Path, config: dict) -> None:
    """The coursework's 7-line ``.params`` file."""
    p = config["params"]
    keys = ("nx", "ny", "maxIters", "reynolds_dim", "density", "accel", "omega")
    pathlib.Path(path).write_text("".join(f"{p[k]!r}\n" for k in keys))


def write_obstacles(path: pathlib.Path, mask: np.ndarray) -> None:
    """The coursework's ``x y 1`` obstacle file, a line a blocked cell."""
    ys, xs = np.nonzero(mask)
    pathlib.Path(path).write_text("".join(f"{x} {y} 1\n" for x, y in zip(xs, ys)))

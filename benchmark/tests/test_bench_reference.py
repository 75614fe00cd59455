"""The plain reference against a D2Q9 step written out cell by cell, as the
coursework's C code loops, at a tiny grid in float64."""

import numpy as np
import pytest
import torch
from conftest import BENCH

from lbmbench import cases, spec

ref = spec.load_module(BENCH / "references" / "d2q9_bgk.py")

PARAMS = {"nx": 7, "ny": 6, "maxIters": 5, "reynolds_dim": 10, "density": 0.1,
          "accel": 0.05, "omega": 1.7}
C = [(0, 0), (1, 0), (0, 1), (-1, 0), (0, -1), (1, 1), (-1, 1), (-1, -1), (1, -1)]
OPP = [0, 3, 4, 1, 2, 7, 8, 5, 6]
W = [4 / 9] + [1 / 9] * 4 + [1 / 36] * 4


def hand_step(f, blocked, p):
    """One step of ``f[9][ny][nx]`` (lists of floats), cell by cell."""
    ny, nx = p["ny"], p["nx"]
    w1 = p["density"] * p["accel"] / 9.0
    w2 = p["density"] * p["accel"] / 36.0
    f = [[row[:] for row in plane] for plane in f]
    y = ny - 2
    for x in range(nx):
        if (not blocked[y][x] and f[3][y][x] - w1 > 0 and f[6][y][x] - w2 > 0
                and f[7][y][x] - w2 > 0):
            f[1][y][x] += w1
            f[5][y][x] += w2
            f[8][y][x] += w2
            f[3][y][x] -= w1
            f[6][y][x] -= w2
            f[7][y][x] -= w2
    out = [[[0.0] * nx for _ in range(ny)] for _ in range(9)]
    tot_u, fluid_cells = 0.0, 0
    for y in range(ny):
        for x in range(nx):
            t = [f[k][(y - C[k][1]) % ny][(x - C[k][0]) % nx] for k in range(9)]
            rho = sum(t)
            ux = sum(t[k] * C[k][0] for k in range(9)) / rho
            uy = sum(t[k] * C[k][1] for k in range(9)) / rho
            if blocked[y][x]:
                for k in range(9):
                    out[k][y][x] = t[OPP[k]]
                continue
            usq = ux * ux + uy * uy
            for k in range(9):
                cu = C[k][0] * ux + C[k][1] * uy
                feq = W[k] * rho * (1 + 3 * cu + 4.5 * cu * cu - 1.5 * usq)
                out[k][y][x] = t[k] + p["omega"] * (feq - t[k])
            tot_u += usq ** 0.5
            fluid_cells += 1
    return out, tot_u / fluid_cells


@pytest.fixture
def case():
    config = {"params": PARAMS,
              "obstacles": {"family": "channel_box", "side_walls": True,
                            "top_bottom_walls": False, "interior_row": 2,
                            "interior_col": None}}
    blocked = cases.published_walls(config)
    blocked[4, 3] = True
    f0 = cases.initial_state(config, {"amplitude": 0.3}, 99, 0, "cpu").double()
    return blocked, f0


def test_reference_matches_the_hand_step(case):
    blocked, f0 = case
    f = f0.numpy().tolist()
    av = []
    for _ in range(PARAMS["maxIters"]):
        f, a = hand_step(f, blocked.tolist(), PARAMS)
        av.append(a)
    solver = ref.Solver(PARAMS, blocked, 1, torch.float64, "cpu")
    got_f, got_av = solver.run(f0[None], PARAMS["maxIters"])
    np.testing.assert_allclose(got_av[0], av, rtol=1e-12)
    np.testing.assert_allclose(solver_state(solver, f0), np.array(f), rtol=1e-12, atol=1e-15)


def solver_state(solver, f0):
    f = f0[None].clone()
    av = torch.empty(1, dtype=torch.float64)
    for _ in range(PARAMS["maxIters"]):
        solver.step(f, av)
    return f[0].numpy()


def test_the_kick_fires_only_where_populations_stay_positive(case):
    blocked, f0 = case
    f0 = f0.clone()
    f0[3, PARAMS["ny"] - 2, 2] = 1e-4  # below w1: this cell is not kicked
    f = f0.numpy().tolist()
    want, _ = hand_step(f, blocked.tolist(), PARAMS)
    solver = ref.Solver(PARAMS, blocked, 1, torch.float64, "cpu")
    got = f0[None].clone()
    solver.step(got, torch.empty(1, dtype=torch.float64))
    np.testing.assert_allclose(got[0].numpy(), np.array(want), rtol=1e-12, atol=1e-15)


def test_batch_runs_each_state_alone(case):
    blocked, f0 = case
    other = f0.flip(-1).contiguous()
    solver2 = ref.Solver(PARAMS, blocked, 2, torch.float64, "cpu")
    f2, av2 = solver2.run(torch.stack([f0, other]), 3)
    solver1 = ref.Solver(PARAMS, blocked, 1, torch.float64, "cpu")
    f1, av1 = solver1.run(other[None], 3)
    np.testing.assert_array_equal(av2[1], av1[0])
    np.testing.assert_array_equal(f2[1].numpy(), f1[0].numpy())


def test_fields_of_a_state(case):
    blocked, f0 = case
    fields = ref.fields(f0, blocked, PARAMS["density"])
    f = f0.numpy()
    rho = f.sum(0)
    ux = (f[1] + f[5] + f[8] - f[3] - f[6] - f[7]) / rho
    assert np.all(fields[0][blocked] == 0) and np.all(fields[3][blocked] == 0.1 / 3)
    np.testing.assert_allclose(fields[0][~blocked], ux[~blocked], rtol=1e-12)
    np.testing.assert_allclose(fields[3][~blocked], rho[~blocked] / 3, rtol=1e-12)

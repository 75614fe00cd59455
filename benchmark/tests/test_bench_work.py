"""The frozen work count and the roofline arithmetic at both cases."""

import json

import pytest
from conftest import BENCH

from lbmbench import work

H100 = json.loads((BENCH / "peaks.json").read_text())["devices"]["NVIDIA H100 80GB HBM3"]


@pytest.mark.parametrize("nx, ny, steps, seconds", [
    (1024, 1024, 20000, 104 * 1024 * 1024 * 20000 / 67e12),
    (256, 256, 80000, 104 * 256 * 256 * 80000 / 67e12),
])
def test_least_time_is_compute_bound_at_both_cases(nx, ny, steps, seconds):
    least, bound = work.least_time(nx, ny, steps, H100)
    assert bound == "compute"
    assert least == pytest.approx(seconds, rel=1e-12)


def test_published_cases_least_times():
    assert work.least_time(1024, 1024, 20000, H100)[0] == pytest.approx(0.0325528, abs=1e-7)
    assert work.least_time(256, 256, 80000, H100)[0] == pytest.approx(0.0081382, abs=1e-7)


def test_bytes_counted_once_a_solve():
    # f0 and the mask read once, the 16-bit fields payload and av written once.
    assert work.solve_bytes(1024, 1024, 20000) == 1024 * 1024 * (36 + 1 + 6) + 4 * 20000
    assert work.solve_flop(256, 256, 80000) == 104 * 256 * 256 * 80000


def test_memory_bound_where_bytes_dominate():
    # One step of a large grid: the bytes of f0 and the payload outweigh
    # 104 operations a cell at these peaks.
    least, bound = work.least_time(4096, 4096, 1, H100)
    assert bound == "memory"
    assert least == pytest.approx(work.solve_bytes(4096, 4096, 1) / 3.35e12)

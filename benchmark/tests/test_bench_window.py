"""The window's accounting with a stubbed job: whole jobs only, all the work
over all the time."""

import time
import types

import pytest

from lbmbench import harness, spec


def stub(seconds_a_job, fail_at=()):
    def job(i):
        time.sleep(seconds_a_job)
        if i in fail_at:
            raise RuntimeError("planted")
        return types.SimpleNamespace(index=i, updates=1000)

    return job


def test_window_holds_whole_jobs_and_all_their_time():
    jobs, attempted, failed, window_s, job_s = harness.run_window(stub(0.03), 0.1)
    assert failed == 0 and attempted == len(jobs)
    assert [j.index for j in jobs] == list(range(attempted))
    # The job running when the time is up completes and is counted.
    assert window_s >= 0.1
    assert window_s == pytest.approx(0.03 * attempted, abs=0.02)
    assert window_s < 0.1 + 0.03 + 0.02
    assert sum(job_s) == pytest.approx(window_s) and len(job_s) == attempted


def test_failed_jobs_are_counted_and_the_loop_goes_on():
    jobs, attempted, failed, _, _ = harness.run_window(stub(0.01, fail_at={1, 2}), 0.08)
    assert failed == 2
    assert attempted == len(jobs) + 2
    assert 1 not in [j.index for j in jobs]


def test_mlups_is_all_the_work_over_all_the_time(tiny_root):
    bench = spec.Spec.load(tiny_root)
    cell = bench.cell("tiny.solve")
    jobs, attempted, failed, window_s, _ = harness.run_window(stub(0.02), 0.05)
    run = harness.RunRecord(cell, "cpu", None, 1.0, window_s, attempted, failed, jobs)
    mlups = bench.reader("mlups")(run)
    assert mlups == pytest.approx(1000 * len(jobs) / window_s / 1e6)
    assert bench.reader("cli_run_s")(run) is None  # a solve cell has no CLI runs


def test_cli_run_s_is_the_window_over_the_runs(tiny_root):
    bench = spec.Spec.load(tiny_root)
    cell = bench.cell("tiny.cli")
    run = harness.RunRecord(cell, "cpu", None, 1.0, 2.0, 5, 0, [object()] * 5)
    assert bench.reader("cli_run_s")(run) == pytest.approx(0.4)
    assert bench.reader("mlups")(run) is None

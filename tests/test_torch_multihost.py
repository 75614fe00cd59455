"""A sharded mesh over real processes: ``lbm_tpu_torch.tools.multihost_smoke``.

The three cases of ``tests/test_checkpoint.py::test_multihost_smoke`` run
through gloo over localhost on the CPU (``LBM_DEVICE=cpu``, the plain
versions): each worker checks its final f bitwise against the
single-device run, av bitwise against the same mesh in one process, the
committed meta and a resume on the other mesh shape.  Then the snapshot
the processes wrote together is held against ``lbm_tpu``: its single
-process reference run, and its own loader reading the port's files.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from lbm_tpu import checkpoint as jax_ckpt
from lbm_tpu.config import LBMParams as JaxParams
from lbm_tpu.geometry import channel_box as jax_channel_box
from lbm_tpu.runtime import Simulator as JaxSimulator
from lbm_tpu_torch import checkpoint as ckpt

ROOT = pathlib.Path(__file__).resolve().parents[1]
IDS = ["1d-2x2", "1d-2x4", "2d-2x2"]
CASES = [
    ([], "PASS: 2 processes x 2 devices (1-D mesh)"),
    (["--procs", "2", "--local-devices", "4"], "PASS: 2 processes x 4 devices (1-D mesh)"),
    (["--mesh", "2x2"], "PASS: 2 processes x 2 devices (mesh 2x2)"),
]
STEPS = 40
# test_reference_matches_lbm_tpu_sharded's tolerances.
F_ATOL, AV_RTOL = 1e-6, 1e-4


@pytest.fixture(scope="module")
def coordinators(tmp_path_factory):
    """The three cases' coordinator runs, started together (each waits
    mostly on its processes' start-up), with their work directories kept;
    any left running at the end are killed."""
    env = dict(os.environ, LBM_DEVICE="cpu", OMP_NUM_THREADS="1")
    runs = {}
    for case_id, (extra, banner) in zip(IDS, CASES):
        workdir = tmp_path_factory.mktemp(case_id)
        out = open(workdir / "coordinator.out", "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "lbm_tpu_torch.tools.multihost_smoke", *extra,
             "--workdir", str(workdir)],
            cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT, text=True)
        runs[case_id] = [proc, out, banner, workdir]
    yield runs
    for proc, out, *_ in runs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()


@pytest.fixture(params=IDS)
def smoke(request, coordinators):
    """``(exit code, output, banner, work directory)`` of one case."""
    proc, out, banner, workdir = coordinators[request.param]
    code = proc.wait(timeout=600)
    out.flush()
    return code, (workdir / "coordinator.out").read_text(), banner, workdir


@pytest.fixture(scope="module")
def jax_reference():
    """lbm_tpu's single-process reference run of the smoke's case."""
    params = JaxParams(128, 64, STEPS, 10, 0.1, 0.005, 1.85)
    res = JaxSimulator(params, jax_channel_box(128, 64, interior_row=29),
                       kernel="reference").run()
    return np.asarray(res.f), np.asarray(res.av_vels)


def test_multihost_smoke(smoke):
    """Every worker passed its checks and the coordinator says so; its
    summary names both process counts' times, and on the CPU no kernel
    launched."""
    code, out, banner, _ = smoke
    assert code == 0, out
    assert banner in out
    assert out.count(": PASS") == 2
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["procs"] == 2 and summary["steps"] == STEPS
    assert summary["variant"] == "reference" and summary["launches"] == {}
    assert summary["us_per_step"] > 0 and summary["us_per_step_one_process"] > 0
    assert "over 2 processes" in summary["mesh"]


def test_multihost_snapshot_matches_lbm_tpu(smoke, jax_reference):
    """The snapshot the processes committed together, against lbm_tpu:
    its loader reads the same f bits and av as the port's, and the final f
    and av agree with its single-process reference run."""
    code, out, _, workdir = smoke
    assert code == 0, out
    ours = ckpt.load(workdir / "ck")
    theirs = jax_ckpt.load(workdir / "ck")
    assert ours.step == theirs.step == STEPS
    np.testing.assert_array_equal(np.asarray(theirs.f), ours.f)
    np.testing.assert_array_equal(np.asarray(theirs.av_vels), ours.av_vels)
    f, av = jax_reference
    np.testing.assert_allclose(ours.f, f, rtol=0, atol=F_ATOL)
    np.testing.assert_allclose(ours.av_vels, av, rtol=AV_RTOL)
    meta = json.loads((workdir / "ck" / ckpt.META_FILENAME).read_text())
    assert not list((workdir / "ck").glob("*.tmp*"))
    assert len(meta["shards"]) == (8 if "4 devices" in out else 4)

"""The port's CLI end to end on the CPU: run -> files -> the checker passes
against lbm_tpu's CLI output and the golden prefix; checkpointed runs
resume; unported flags raise; autotune runs."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from lbm_tpu import cli as jax_cli
from lbm_tpu_torch import cli
from lbm_tpu_torch.checker import check_files
from lbm_tpu_torch.config import CANONICAL_PARAMS
from lbm_tpu_torch.geometry import canonical_obstacles, write_obstacle_file

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "goldens" / "128x128.fp64gen_av_vels.dat"
STEPS = 200


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The grids here are small, and the suite runs in parallel workers:
    intra-op threads only contend (measured 3x slower at 128x128)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def case_files(tmp_path):
    params = dataclasses.replace(CANONICAL_PARAMS["128x128"], max_iters=40000)
    params.to_file(tmp_path / "input.params")
    write_obstacle_file(tmp_path / "obstacles.dat", canonical_obstacles("128x128"))
    return tmp_path


def test_run_matches_lbm_tpu_cli_and_golden_prefix(case_files, capsys):
    d = case_files
    args = [str(d / "input.params"), str(d / "obstacles.dat"), "--max-iters", str(STEPS)]
    env = {**os.environ, "LBM_DEVICE": "cpu", "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "lbm_tpu_torch.cli", "run", *args,
         "--output-dir", str(d / "ours")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    for line in ("==done==", "Reynolds number:", "Elapsed time:",
                 "Elapsed user CPU time:", "Elapsed system CPU time:", "MLUPS:",
                 "Effective bandwidth:"):
        assert line in proc.stdout
    assert jax_cli.main(["run", *args, "--output-dir", str(d / "theirs")]) == 0
    capsys.readouterr()
    ours, theirs = d / "ours", d / "theirs"
    res = check_files(
        ref_av_vels=str(theirs / "av_vels.dat"),
        ref_final_state=str(theirs / "final_state.dat"),
        av_vels=str(ours / "av_vels.dat"),
        final_state=str(ours / "final_state.dat"),
    )
    assert res.ok and max(abs(v) for v in res.worst_pct.values()) < 0.01
    lines = GOLDEN.read_text().splitlines()[:STEPS]
    (d / "golden.dat").write_text("\n".join(lines) + "\n")
    assert check_files(ref_av_vels=str(d / "golden.dat"),
                       av_vels=str(ours / "av_vels.dat")).ok
    assert cli.main(["check", "--ref-av-vels-file", str(d / "golden.dat"),
                     "--av-vels-file", str(ours / "av_vels.dat")]) == 0
    bad = np.loadtxt(ours / "av_vels.dat", usecols=[1]) * 1.02
    (d / "bad.dat").write_text("".join(f"{i}:\t{v:.12E}\n" for i, v in enumerate(bad)))
    assert cli.main(["check", "--ref-av-vels-file", str(d / "golden.dat"),
                     "--av-vels-file", str(d / "bad.dat")]) == 1


def test_bare_invocation_profile_and_bench(case_files, capsys, monkeypatch):
    d = case_files
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    assert cli.main([str(d / "input.params"), str(d / "obstacles.dat"),
                     "--max-iters", "5", "--output-dir", str(d / "o"),
                     "--profile", str(d / "prof")]) == 0
    assert "==done==" in capsys.readouterr().out
    assert len((d / "o" / "av_vels.dat").read_text().splitlines()) == 5
    assert (d / "prof" / "trace.json").stat().st_size > 0
    assert cli.main(["bench", str(d / "input.params"), str(d / "obstacles.dat"),
                     "--max-iters", "5", "--repeats", "2"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "MLUPS 128x128" and rec["steps"] == 5
    assert rec["device"] == "cpu" and rec["value"] > 0
    with pytest.raises(SystemExit, match="both"):
        cli.main(["bench", str(d / "input.params")])


@pytest.mark.parametrize(
    "extra",
    [["--shards", "2", "--temporal-split", "8x4x2"],
     ["--mesh", "2x2", "--temporal-split", "8x4x2"],
     ["--temporal-split", "32x4x2", "--shards", "4"]],
    ids=lambda e: e[0],
)
def test_unported_run_flags_raise(case_files, extra, monkeypatch, capsys):
    """lbm_tpu's x-tiled sharded split (BYxKxPX) runs with --shards and
    writes the single-device run's files (final_state.dat byte for byte,
    av_vels within 1e-5 relative); on a mesh with two x shards it raises
    lbm_tpu's "x shard" refusal before anything runs."""
    d = case_files
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    base = ["run", str(d / "input.params"), str(d / "obstacles.dat"), "--max-iters", "24"]
    if extra[0] == "--mesh":
        with pytest.raises(ValueError, match="x shard"):
            cli.main([*base, *extra, "--output-dir", str(d / "sharded")])
        assert not (d / "sharded" / "av_vels.dat").exists()
        return
    assert cli.main([*base, *extra, "--output-dir", str(d / "sharded")]) == 0
    assert "Kernel variant: temporal (steps/pass 4)" in capsys.readouterr().out
    assert cli.main([*base, "--output-dir", str(d / "single")]) == 0
    capsys.readouterr()
    assert ((d / "sharded" / "final_state.dat").read_bytes()
            == (d / "single" / "final_state.dat").read_bytes())
    np.testing.assert_allclose(np.loadtxt(d / "sharded" / "av_vels.dat", usecols=[1]),
                               np.loadtxt(d / "single" / "av_vels.dat", usecols=[1]),
                               rtol=1e-5)


@pytest.mark.parametrize(
    "extra, match",
    [(["--shards", "2", "--kernel", "mega"], "single-chip"),
     (["--mesh", "2x2", "--device", "cpu"], "--device cannot"),
     (["--mesh", "2x2", "--shards", "2"], "not both"),
     (["--shards", "0"], "positive"),
     (["--mesh", "2by2"], "must be AxB"),
     (["--temporal-split", "32x4"], "applies to the sharded"),
     (["--shards", "2", "--temporal-split", "32"], "BYxK"),
     (["--shards", "2", "--temporal-split", "32x4", "--kernel", "reference"],
      "requires a CUDA kernel")],
    ids=["mega", "device", "both", "zero", "bad-mesh", "split-unsharded", "bad-split",
         "split-reference"],
)
def test_sharded_run_refusals(case_files, extra, match, monkeypatch):
    """lbm_tpu's checks and messages (lbm_tpu/cli.py:120-135, 166-248)."""
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    with pytest.raises(SystemExit, match=match):
        cli.main(["run", str(case_files / "input.params"),
                  str(case_files / "obstacles.dat"), *extra])


@pytest.mark.parametrize("extra", [["--shards", "4"], ["--mesh", "2x2"],
                                   ["--shards", "2", "--temporal-split", "32x4"]],
                         ids=["shards", "mesh", "split"])
def test_sharded_run_matches_single_device(case_files, extra, monkeypatch, capsys):
    """``run --shards 4`` and ``--mesh 2x2`` on the CPU: final_state.dat is
    the single-device run's byte for byte (f and the fields payload are the
    same bits), av_vels within 1e-5 relative (the shards' sums add in
    another order)."""
    d = case_files
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    base = ["run", str(d / "input.params"), str(d / "obstacles.dat"), "--max-iters", "24"]
    assert cli.main([*base, *extra, "--output-dir", str(d / "sharded")]) == 0
    out = capsys.readouterr().out
    assert "Mesh: " in out and "shard(s): cpu x" in out and "Kernel variant: " in out
    assert cli.main([*base, "--output-dir", str(d / "single")]) == 0
    capsys.readouterr()
    assert ((d / "sharded" / "final_state.dat").read_bytes()
            == (d / "single" / "final_state.dat").read_bytes())
    np.testing.assert_allclose(np.loadtxt(d / "sharded" / "av_vels.dat", usecols=[1]),
                               np.loadtxt(d / "single" / "av_vels.dat", usecols=[1]),
                               rtol=1e-5)


def test_sharded_checkpointed_cli_run_resumes_bitwise(case_files, monkeypatch, capsys):
    """A sharded checkpointed run stopped at 16 steps and resumed to 40
    writes the same files, byte for byte, as an uninterrupted one."""
    d = case_files
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    base = ["run", str(d / "input.params"), str(d / "obstacles.dat"), "--mesh", "2x2",
            "--checkpoint-every", "8"]
    assert cli.main([*base, "--max-iters", "40", "--checkpoint-dir", str(d / "a"),
                     "--output-dir", str(d / "whole")]) == 0
    assert cli.main([*base, "--max-iters", "16", "--checkpoint-dir", str(d / "b"),
                     "--output-dir", str(d / "crash")]) == 0
    assert cli.main([*base, "--max-iters", "40", "--checkpoint-dir", str(d / "b"),
                     "--output-dir", str(d / "resumed")]) == 0
    capsys.readouterr()
    assert len(list((d / "b").glob("lbm_checkpoint.step40.shard.*.npz"))) == 4
    for name in ("av_vels.dat", "final_state.dat"):
        assert (d / "whole" / name).read_bytes() == (d / "resumed" / name).read_bytes()


@pytest.mark.parametrize(
    "extra",
    [["--checkpoint-dir", "ckpt"], ["--checkpoint-every", "10"], ["--kernel", "mega"]],
    ids=lambda e: e[0] + (e[1] if e[0] == "--kernel" else ""),
)
def test_checkpoint_and_mega_flags_run(case_files, extra, monkeypatch, capsys):
    """The flags lbm_tpu answers with a checkpointed run or the megakernel
    run here too, with the outputs of a plain run of the same steps.
    ``--checkpoint-every`` alone snapshots nothing, as in lbm_tpu."""
    d = case_files
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    monkeypatch.chdir(d)
    base = ["run", str(d / "input.params"), str(d / "obstacles.dat"), "--max-iters", "24"]
    assert cli.main([*base, *extra, "--output-dir", str(d / "flag")]) == 0
    assert cli.main([*base, "--output-dir", str(d / "plain")]) == 0
    assert "==done==" in capsys.readouterr().out
    ours = np.loadtxt(d / "flag" / "av_vels.dat", usecols=[1])
    plain = np.loadtxt(d / "plain" / "av_vels.dat", usecols=[1])
    assert ours.shape == (24,)
    np.testing.assert_allclose(ours, plain, rtol=1e-5)
    assert check_files(ref_av_vels=str(d / "plain" / "av_vels.dat"),
                       ref_final_state=str(d / "plain" / "final_state.dat"),
                       av_vels=str(d / "flag" / "av_vels.dat"),
                       final_state=str(d / "flag" / "final_state.dat")).ok
    assert (d / "ckpt" / "lbm_checkpoint.npz").exists() == (extra[0] == "--checkpoint-dir")


def test_checkpointed_cli_run_resumes_bitwise(case_files, monkeypatch, capsys):
    """A checkpointed run stopped at 16 steps (``--max-iters``) and resumed
    to 40 writes the same files, byte for byte, as an uninterrupted
    checkpointed run."""
    d = case_files
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    base = ["run", str(d / "input.params"), str(d / "obstacles.dat"),
            "--checkpoint-every", "8"]
    assert cli.main([*base, "--max-iters", "40", "--checkpoint-dir", str(d / "a"),
                     "--output-dir", str(d / "whole")]) == 0
    assert cli.main([*base, "--max-iters", "16", "--checkpoint-dir", str(d / "b"),
                     "--output-dir", str(d / "crash")]) == 0
    assert cli.main([*base, "--max-iters", "40", "--checkpoint-dir", str(d / "b"),
                     "--output-dir", str(d / "resumed")]) == 0
    capsys.readouterr()
    for name in ("av_vels.dat", "final_state.dat"):
        assert (d / "whole" / name).read_bytes() == (d / "resumed" / name).read_bytes()


def test_kernel_temporal_is_the_single_device_alias(case_files, monkeypatch, capsys):
    """As in lbm_tpu, ``--kernel temporal`` on one device runs the kernel
    schedule that ``auto`` runs."""
    d = case_files
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    for kernel in ("temporal", "auto"):
        assert cli.main(["run", str(d / "input.params"), str(d / "obstacles.dat"),
                         "--max-iters", "16", "--kernel", kernel,
                         "--output-dir", str(d / kernel)]) == 0
    assert "==done==" in capsys.readouterr().out
    for name in ("av_vels.dat", "final_state.dat"):
        assert (d / "temporal" / name).read_text() == (d / "auto" / name).read_text()
    assert len((d / "temporal" / "av_vels.dat").read_text().splitlines()) == 16


def test_unported_subcommands_raise(tmp_path, monkeypatch, capsys):
    """``autotune`` is ported: it now runs (the timer stubbed, since it
    times the kernels on the card) and ``--dry-run`` writes no cache."""
    from lbm_tpu_torch import tuning

    cache = tmp_path / "cache.json"
    monkeypatch.setenv("LBM_TUNING_CACHE", str(cache))
    monkeypatch.setattr(tuning, "time_temporal_candidate",
                        lambda params, obstacles, by, bx, k, steps, repeats, log=print,
                        schedule="temporal", storage=None: 100.0 - by / 8 - bx / 64 - k)
    assert cli.main(["autotune", "--case", "128x128", "--dry-run"]) == 0
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (payload["ny"], payload["nx"], payload["schedule"]) == (128, 128, "temporal")
    assert not cache.exists()
    with pytest.raises(SystemExit, match="exactly one of --case / --grid"):
        cli.main(["autotune", "--case", "128x128", "--grid", "128x128"])

"""The study tools of the port (``lbm_tpu_torch.tools.ablate_step`` and
``lbm_tpu_torch.tools.roofline``) on the CPU: their plain versions against
``lbm_tpu``'s tool kernels (``tools/ablate_step.py::build_ablated``,
``tools/vpu_roofline.py::_build``) run with ``pl.pallas_call`` forced to
interpret mode, as ``tests/test_tools.py`` runs them; the wrappers' refusal
to run the plain version for anything but a CPU tensor; the CLIs.

Tolerances: ablation ``noop`` and ``stream`` move values only, so bitwise;
``collide`` is K steps of the physics, summed in another order than
``lbm_tpu``'s window kernel, so f within atol 1e-6 (the port's standing
tolerance against ``lbm_tpu``); each roofline mix within 1e-6 relative
(the same fp32 operations; the IEEE division and sqrt of both sides are
correctly rounded).  The card holds the kernels against these plain
versions (``chip_smoke.py``).
"""

import dataclasses
import importlib.util
import json
import pathlib

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbm_tpu
from lbm_tpu.ops.fused import build_temporal_program
from lbm_tpu.ops.reference import accel_weights
from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.geometry import free_cells_of
from lbm_tpu_torch.ops import _build, fused
from lbm_tpu_torch.testing import gate_case
from lbm_tpu_torch.tools import ablate_step, roofline

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"
CPU = torch.device("cpu")


def _load(name):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def interpret_pallas(monkeypatch):
    """Force interpret mode for pallas_call built inside a tool."""
    orig = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call",
        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}),
    )


@pytest.fixture(scope="module")
def ablation_case():
    """128x64 from a seeded state (non-uniform, so the pulls move values),
    BY 16, K 4: lbm_tpu's ablated passes, one per mode."""
    params, obstacles, f0 = gate_case(64, 128, seed=5)
    params = dataclasses.replace(params, max_iters=8)
    return params, obstacles, f0


@pytest.mark.parametrize("mode", ablate_step.MODES)
def test_ablation_plain_matches_lbm_tpu(ablation_case, interpret_pallas, mode):
    params, obstacles, f0 = ablation_case
    by, k = 16, 4
    jparams = lbm_tpu.LBMParams(**dataclasses.asdict(params))
    fcinv = np.float32(1.0) / np.float32(free_cells_of(obstacles))
    prog = build_temporal_program(jparams, obstacles, fcinv, by, k, interpret=True)
    aw1, aw2 = accel_weights(jparams)
    call = _load("ablate_step").build_ablated(
        mode, params.ny, params.nx, by, k, float(np.float32(params.omega)), float(aw1),
        float(aw2))
    f, gs, gn, maskext = prog.init(jnp.asarray(f0))
    theirs = np.asarray(call(f, gs, gn, maskext)[0])
    ours = ablate_step.AblatedStep(mode, params, obstacles, CPU, by, 32, k).plain_launch(
        torch.from_numpy(f0)).numpy()
    if mode == "collide":
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)
        # ... and bitwise the port's own temporal pass (what the card holds
        # the collide kernel to: the production kernel's f).
        temporal = fused.TemporalStep(params, obstacles, fcinv, CPU, by, 32, k)
        np.testing.assert_array_equal(
            ours, temporal.plain_launch(torch.from_numpy(f0))[0].numpy())
    else:
        np.testing.assert_array_equal(ours, theirs)
        if mode == "noop":
            np.testing.assert_array_equal(ours, f0)
        else:
            assert not np.array_equal(ours, f0)


@pytest.mark.parametrize("mix", roofline.MIXES)
def test_roofline_plain_matches_lbm_tpu(interpret_pallas, mix):
    """rows 8, inner 2 (unroll 1): the same recurrence from the same seeded
    x on both sides, and the same issue count (mix pinned at 106)."""
    run, issues = _load("vpu_roofline")._build(mix, rows=8, unroll=1, inner=2, steps=1)
    assert issues == roofline.issues_per_iteration(mix, 1)
    rng = np.random.default_rng(7)
    x = rng.uniform(0.25, 1.5, (8, 128)).astype(np.float32)
    x[0] = rng.uniform(1e-31, 1e-29, 128)  # where the tiny b still moves x + b
    theirs = np.asarray(run(jnp.asarray(x)))
    ours = roofline.plain(mix, torch.from_numpy(x), inner=2, unroll=1).numpy()
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=0)
    assert not np.array_equal(ours, x)
    out = torch.empty(x.size)
    roofline.launch(mix, torch.from_numpy(x.ravel()), out, 2, 1)
    np.testing.assert_array_equal(out.numpy().reshape(x.shape), ours)
    assert roofline.issues_per_iteration("mix", 64) == 106
    assert roofline.issues_per_iteration("fma", 64) == 128


@pytest.mark.parametrize("mix", roofline.MIXES)
def test_roofline_a_and_b_reach_the_recurrence(mix):
    """``a`` and ``b`` are the wrapper's arguments, as they are the kernel's:
    at b = 1e-3 every add moves x (at lbm_tpu's 1e-30 an x of order 1 does
    not move), so a check of the kernel with it sees every add and every
    iteration; add and fma then equal x + n*b and its fma form in float64
    within fp32 rounding."""
    x = torch.from_numpy(np.random.default_rng(3).uniform(0.25, 1.5, 256)
                         .astype(np.float32))
    inner, unroll, b = 3, 4, 1e-3
    out = torch.empty_like(x)
    roofline.launch(mix, x, out, inner, unroll, b=b)
    np.testing.assert_array_equal(out.numpy(),
                                  roofline.plain(mix, x, inner, unroll, b=b).numpy())
    assert bool((out != x).all())
    assert not torch.equal(out, roofline.plain(mix, x, inner, unroll))
    assert not torch.equal(out, roofline.plain(mix, x, inner - 1, unroll, b=b))
    x64, n = x.double().numpy(), inner * unroll
    a = float(roofline.A)
    if mix == "add":
        np.testing.assert_allclose(out.numpy(), x64 + n * b, rtol=1e-5)
    elif mix == "fma":
        np.testing.assert_allclose(out.numpy(), x64 * a**n + b * (a**n - 1) / (a - 1),
                                   rtol=1e-5)


def test_wrappers_never_take_the_plain_path_on_other_devices(monkeypatch):
    """For a tensor that is not on the CPU the ablation and roofline
    wrappers launch their kernels or raise; nothing falls back to the plain
    version."""
    params = LBMParams(64, 32, 8, 10, 0.1, 0.005, 1.85)
    obstacles = np.zeros((32, 64), bool)
    step = ablate_step.AblatedStep("collide", params, obstacles, CPU, 16, 32, 4)

    def no_plain(*args, **kwargs):
        raise AssertionError("the CUDA path fell back to the plain version")

    monkeypatch.setattr(step, "plain_launch", no_plain)
    monkeypatch.setattr(roofline, "plain", no_plain)
    launches = dict(fused.LAUNCHES)
    f = torch.empty(9, 32, 64, device="meta")
    with pytest.raises(ValueError, match="contiguous float32"):
        step.bind(f, torch.empty_like(f))
    x = torch.empty(128, device="meta")

    def failing_build():
        raise _build.BuildError("simulated build failure")

    monkeypatch.setattr(_build, "load_library", failing_build)
    with pytest.raises(_build.BuildError, match="simulated"):
        roofline.launch("add", x, torch.empty_like(x), 2, 1)
    with pytest.raises(_build.BuildError, match="simulated"):
        ablate_step.AblatedStep("noop", params, obstacles, torch.device("cuda", 0), 16, 32, 4)
    monkeypatch.setattr(_build, "load_library", lambda: object())
    with pytest.raises(ValueError, match="distinct buffer"):
        roofline.launch("mix", x, torch.empty_like(x), 2, 1)
    assert fused.LAUNCHES == launches


@pytest.mark.parametrize(
    "by, bx, k, match",
    [(24, 64, 4, "does not divide"), (32, 64, 0, "K must be"),
     (64, 128, 8, "shared memory"), (8, 256, 2, "shared memory")],
    ids=["tile", "k", "smem", "smem-persistent"],
)
def test_ablation_rejects_invalid_tiles(by, bx, k, match):
    with pytest.raises(ValueError, match=match):
        ablate_step.check_tile(1024, 1024, by, bx, k)
    with pytest.raises(SystemExit):
        ablate_step.main(["--by", str(by), "--bx", str(bx), "--k", str(k)])


def test_tool_clis_on_the_cpu(monkeypatch, capsys):
    """The roofline CLI runs its plain versions with LBM_DEVICE=cpu and
    prints lbm_tpu's JSON keys; the ablation's turns and attribution."""
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    assert roofline.main(["--rows", "8", "--inner", "2", "--steps", "1",
                          "--unroll", "2"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["mix"] for r in recs] == ["add", "fma", "mix"]
    assert [r["traced_ops_per_elem_iter"] for r in recs] == [2, 4, 106]
    assert all(r["Gissue_per_s"] > 0 and r["device"] == "cpu" for r in recs)
    assert recs[2]["cell_updates_per_s_ceiling"] == pytest.approx(
        recs[2]["Gissue_per_s"] * 1e9 / 106)
    us = {"noop": 1.0, "stream": 3.0, "collide": 10.0, "full": 12.0}
    assert ablate_step.attribution(us) == {"dma_overhead": 1.0, "streaming_rolls": 2.0,
                                           "kick_and_collision": 7.0,
                                           "av_reduction": 2.0}
    turns = ablate_step.time_modes(LBMParams(64, 32, 8, 10, 0.1, 0.005, 1.85),
                                   np.zeros((32, 64), bool), CPU, 16, 32, 4, 4)
    assert set(turns) == {"noop", "stream", "collide", "full"}
    assert all(len(t) == 2 and min(t) > 0 for t in turns.values())


def _final_state(tmp_path) -> pathlib.Path:
    """A final_state.dat written by the port (32x16, plain torch)."""
    from lbm_tpu_torch.geometry import channel_box
    from lbm_tpu_torch.io import write_final_state
    from lbm_tpu_torch.runtime import Simulator

    params = LBMParams(32, 16, 20, 10, 0.1, 0.005, 1.85)
    res = Simulator(params, channel_box(32, 16), kernel="reference", device=CPU).run()
    fs = tmp_path / "final_state.dat"
    write_final_state(fs, params, res.f, res.obstacles)
    return fs


def test_plot_tool(tmp_path):
    """``tests/test_utils.py::test_plot_tool`` on a final_state.dat of the
    port: the heatmap of its |u| column is written."""
    pytest.importorskip("matplotlib")
    from lbm_tpu_torch.tools.plot_final_state import main as plot_main

    out = tmp_path / "plot.png"
    assert plot_main([str(_final_state(tmp_path)), str(out)]) == 0
    assert out.stat().st_size > 0


def test_plot_tool_without_matplotlib(tmp_path, monkeypatch, capsys):
    """Without matplotlib the tool prints lbm_tpu's message and exits 1;
    a wrong argument count exits 2."""
    import sys

    from lbm_tpu_torch.tools.plot_final_state import main as plot_main

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert plot_main([str(tmp_path / "final_state.dat")]) == 1
    assert "matplotlib not available in this environment" in capsys.readouterr().err
    assert plot_main([]) == 2

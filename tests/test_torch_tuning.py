"""The port's tuning cache and autotuner (``lbm_tpu_torch.tuning``), held
against ``tests/test_tuning.py``'s cases for ``lbm_tpu.tuning`` wherever
Hopper does not change them: persistence, lookup precedence in the
chooser, graceful degradation on bad cache data (the cache must never
become a correctness dependency), candidate enumeration, ``lbm autotune``
with ``--dry-run`` and ``--refresh``, the refresh warnings, the opt-in
slab sweep of the sharded factories, and the same rankings and warnings
as ``lbm_tpu`` from the same stubbed timings.

The timer measures kernels on the card, so it is stubbed here, as
``tests/test_tuning.py`` stubs ``lbm_tpu``'s.  On the CPU the device kind
is ``"cpu"``.
"""

from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbm_tpu
from lbm_tpu import tuning as jax_tuning
from lbm_tpu_torch import cli, tuning
from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.geometry import channel_box, free_cells_of
from lbm_tpu_torch.ops import fused, schedule
from lbm_tpu_torch.parallel import sharded
from lbm_tpu_torch.parallel.mesh import AXIS, AXIS_X, Mesh
from lbm_tpu_torch.runtime import Simulator
from lbm_tpu_torch.testing import gate_case
from lbm_tpu_torch.tools import autotune as autotune_tool

CPU = torch.device("cpu")
KIND = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cache_file(tmp_path, monkeypatch):
    path = tmp_path / "cache.json"
    monkeypatch.setenv("LBM_TUNING_CACHE", str(path))
    monkeypatch.setattr(tuning, "_ATTEMPTED_SWEEPS", set())
    return path


def _fake(calls=None, offset=0.0):
    """A stub timer: bigger tiles and K measure faster (distinct times)."""

    def fake_time(params, obstacles, by, bx, k, steps, repeats, log=print,
                  schedule="temporal", storage=None):
        if calls is not None:
            calls.append((by, bx, k, schedule))
        return 100.0 - by / 8 - bx / 64 - k + offset

    return fake_time


def test_record_and_lookup_roundtrip(cache_file):
    tuning.record("NVIDIA H100 80GB HBM3", 64, 128,
                  [(16, 32, 4, 51.0, "temporal"), (32, 64, 8, 47.0, "temporal")])
    # Sorted fastest-first on read-back.
    assert tuning.lookup("NVIDIA H100 80GB HBM3", 64, 128) == [
        (32, 64, 8, "temporal"), (16, 32, 4, "temporal")]
    assert tuning.lookup("NVIDIA H100 80GB HBM3", 64, 256) == []
    tuning.record("NVIDIA H100 80GB HBM3", 64, 256, [(8, 16, 2, 10.0, "temporal")])
    assert tuning.lookup("NVIDIA H100 80GB HBM3", 64, 128)[0] == (32, 64, 8, "temporal")
    assert tuning.lookup("NVIDIA H100 80GB HBM3", 64, 256) == [(8, 16, 2, "temporal")]
    assert tuning.lookup("other", 64, 128) == []


def test_record_and_lookup_both_schedules(cache_file):
    """Entries are [by, bx, k, us_per_step, schedule] on disk."""
    tuning.record(KIND, 8192, 8192, [(32, 64, 4, 60.0, "temporal"),
                                     (32, 64, 4, 45.0, "xtiled")])
    assert tuning.lookup(KIND, 8192, 8192) == [(32, 64, 4, "xtiled"),
                                               (32, 64, 4, "temporal")]
    raw = json.loads(cache_file.read_text())[f"{KIND}|8192x8192"]
    assert raw == [[32, 64, 4, 45.0, "xtiled"], [32, 64, 4, 60.0, "temporal"]]
    with pytest.raises(ValueError, match="schedule must be one of"):
        tuning.record(KIND, 8, 8, [(8, 8, 2, 1.0, "mega")])


def test_corrupt_or_missing_cache_is_empty(cache_file):
    assert tuning.lookup("x", 8, 8) == []  # missing file
    cache_file.write_text("{not json")
    assert tuning.load_cache() == {}
    cache_file.write_text(json.dumps([1, 2, 3]))  # wrong top-level type
    assert tuning.load_cache() == {}
    # Malformed entries are dropped, well-formed ones survive, and
    # valid-JSON-but-wrong-typed values never raise.
    cache_file.write_text(json.dumps({"k|4x4": [
        [8], [None, 2, 2, 1.0, "temporal"], ["x", 2, 2, 1.0, "temporal"],
        [16, 4, 2, 1.0, "mega"], [16, 4, 2, 1.0], [16, 4, 2, 1.0, "temporal"], "zz"]}))
    assert tuning.lookup("k", 4, 4) == [(16, 4, 2, "temporal")]
    cache_file.write_text(json.dumps({"k|4x4": {"by": 16}}))
    assert tuning.lookup("k", 4, 4) == []
    cache_file.write_bytes(b"\xff\xfe")  # not text
    assert tuning.lookup("k", 4, 4) == []


def test_choose_temporal_prefers_measured_entry(cache_file):
    fixed = schedule.choose_temporal(64, 128, 400)
    assert fixed == schedule.fixed_temporal(64, 128, 400) == (32, 64, 4)
    tuning.record(KIND, 64, 128, [(16, 16, 8, 50.0, "temporal")])
    assert schedule.choose_temporal(64, 128, 400) == (16, 16, 8)
    # The cache is keyed by the device the program will run on.
    assert schedule.choose_temporal(64, 128, 400, device_kind="OtherCard") == fixed
    tuning.record("OtherCard", 64, 128, [(8, 32, 2, 40.0, "temporal")])
    assert schedule.choose_temporal(64, 128, 400, device_kind="OtherCard") == (8, 32, 2)
    assert schedule.choose_temporal(64, 128, 400, device_kind=KIND) == (16, 16, 8)
    # An x-tiled entry is not the row kernel's.
    tuning.record(KIND, 64, 128, [(8, 16, 2, 10.0, "xtiled")])
    assert schedule.choose_temporal(64, 128, 400) == fixed


def test_choose_temporal_skips_invalid_cached_entries(cache_file):
    tuning.record(KIND, 64, 128, [
        (16, 32, 3, 40.0, "temporal"),    # K does not divide max_iters=400
        (24, 32, 4, 41.0, "temporal"),    # BY does not divide ny=64
        (16, 48, 4, 42.0, "temporal"),    # BX does not divide nx=128
        (64, 128, 4, 43.0, "temporal"),   # window beyond a block's shared memory
        (16, 32, 4, 44.0, "temporal"),    # valid
    ])
    assert schedule.choose_temporal(64, 128, 400) == (16, 32, 4)
    # An entry for a different device kind does not apply.
    other = cache_file.parent / "other.json"
    other.write_text(json.dumps({f"not-{KIND}|64x128": [[8, 16, 2, 1.0, "temporal"]]}))
    import os

    os.environ["LBM_TUNING_CACHE"] = str(other)
    try:
        assert schedule.choose_temporal(64, 128, 400) == (32, 64, 4)
    finally:
        os.environ["LBM_TUNING_CACHE"] = str(cache_file)


def test_choose_schedule_takes_the_cache_by_fit(cache_file):
    """Where the ping-pong pair fits, the first valid entry of either
    schedule wins; where it does not, the first valid x-tiled entry; the
    multi-step branch stays first."""
    ny = nx = 8192
    assert schedule.choose_schedule(ny, nx, 20000) == ("temporal", (32, 64, 4))
    assert schedule.choose_schedule(ny, nx, 20000, pingpong_fits=False) == (
        "xtiled", (32, 64, 4))
    tuning.record(KIND, ny, nx, [(16, 64, 8, 30.0, "xtiled"),
                                 (32, 32, 8, 35.0, "temporal")])
    assert schedule.choose_schedule(ny, nx, 20000) == ("xtiled", (16, 64, 8))
    assert schedule.choose_schedule(ny, nx, 20000, pingpong_fits=False) == (
        "xtiled", (16, 64, 8))
    tuning.record(KIND, ny, nx, [(32, 32, 8, 35.0, "temporal"),
                                 (16, 64, 8, 36.0, "xtiled")])
    assert schedule.choose_schedule(ny, nx, 20000) == ("temporal", (32, 32, 8))
    assert schedule.choose_schedule(ny, nx, 20000, pingpong_fits=False) == (
        "xtiled", (16, 64, 8))
    assert schedule.choose_temporal_xtiled(ny, nx, 20000) == (16, 64, 8)
    # Entries that K does not take fall through to the fixed order.
    assert schedule.choose_schedule(ny, nx, 20004) == ("temporal", (32, 64, 4))
    assert schedule.choose_schedule(ny, nx, 20004, pingpong_fits=False) == (
        "xtiled", (32, 64, 4))
    # The multi-step branch is not the cache's.
    tuning.record(KIND, 128, 128, [(32, 64, 4, 1.0, "temporal")])
    assert schedule.choose_schedule(128, 128, 40000) == ("multi", (200,))
    # lbm_tpu's gate still keeps narrow grids off the x-tiled kernel.
    tuning.record(KIND, 1024, 1024, [(32, 64, 4, 1.0, "xtiled")])
    assert schedule.choose_temporal_xtiled(1024, 1024, 20000) is None


def test_autotune_candidate_enumeration():
    """Candidates satisfy the kernel's constraints, literally: tiles from
    the sweep's lattice dividing the grid, K dividing the steps, the
    persistent kernel's two window buffers and two masks within a block's
    shared memory less its two slots of 512 |u| values; the rest go to
    ``skipped``."""
    skipped = []
    cands = tuning.temporal_candidates(1024, 1024, 960, skipped)
    assert (32, 64, 4) in cands and (32, 64, 8) in skipped
    for by, bx, k in cands + skipped:
        assert by in (8, 16, 32, 64, 128) and bx in (16, 32, 64, 128, 256)
        assert k in (2, 4, 8, 16) and 960 % k == 0
    for by, bx, k in cands:
        assert (by + 2 * k) * (bx + 2 * k) * (2 * 9 * 4 + 2) <= 232_448 - 4096
    for by, bx, k in skipped:
        assert (by + 2 * k) * (bx + 2 * k) * (2 * 9 * 4 + 2) > 232_448 - 4096
    assert len(cands) + len(skipped) == 5 * 5 * 4
    # Steps not divisible by 16 drop the K = 16 candidates.
    assert all(k != 16 for _, _, k in tuning.temporal_candidates(1024, 1024, 8))
    # Tiny grids admit what divides them.
    assert tuning.temporal_candidates(8, 16, 2) == [(8, 16, 2)]
    assert tuning.temporal_candidates(4, 16, 2) == []
    # The tool re-exports the same enumeration.
    assert autotune_tool.candidates is tuning.temporal_candidates


def test_xtiled_candidate_enumeration():
    """The x-tiled kernel is a persistent pass with the temporal kernel's
    footprint (two windows and two masks), so its candidates under
    ``lbm_tpu``'s gate are exactly the temporal ones: 8x256 at K 2, whose
    windows fit no block, is pruned from both."""
    cands = tuning.xtiled_candidates(8192, 8192, 960)
    temporal = tuning.temporal_candidates(8192, 8192, 960)
    assert cands == temporal
    skipped = []
    tuning.xtiled_candidates(8192, 8192, 960, skipped)
    assert (8, 256, 2) in skipped and (8, 256, 2) not in cands
    for by, bx, k in cands:
        assert schedule.xtiled_structurally_valid(8192, 8192, by, bx, k, 960)
    # lbm_tpu's gate: narrow or short grids, or widths without strips.
    assert tuning.xtiled_candidates(1024, 1024, 960) == []
    assert tuning.xtiled_candidates(8, 8192, 960) == []
    assert tuning.xtiled_candidates(1024, 8200, 960) == []


@pytest.mark.parametrize("route", ["xtiled", "temporal"])
def test_footprints_keep_each_route_its_tiles(route, cache_file):
    """Every window kernel runs a persistent pass with one footprint (two
    windows and two masks).  8x256 at K 2 does not fit it: neither route
    offers it (its sweep, its check, a cached entry), and each keeps its
    fixed order's tile.  Over the sweep's lattice both routes admit
    exactly the tiles that fit, and skip exactly the others."""
    tile, n = (8, 256, 2), 8192
    assert schedule.persistent_smem_bytes(*tile) == 2 * 36 * 12 * 260 + 2 * 12 * 260
    assert not schedule.persistent_fits(*tile)
    enumerate_ = (tuning.xtiled_candidates if route == "xtiled"
                  else tuning.temporal_candidates)
    assert tile not in enumerate_(n, n, 960)
    assert not schedule.structurally_valid(route, n, n, *tile, 960)
    tuning.record(KIND, n, n, [(*tile, 1.0, route)])
    fixed = schedule.fixed_temporal(n, n, 960)
    assert fixed == (32, 64, 4)
    if route == "xtiled":
        assert schedule.choose_temporal_xtiled(n, n, 960) == fixed
        assert schedule.choose_schedule(n, n, 960, pingpong_fits=False) == ("xtiled", fixed)
    else:
        assert schedule.choose_temporal(n, n, 960) == fixed != tile
        assert schedule.choose_schedule(n, n, 960) == ("temporal", fixed)
    skipped = []
    admitted = enumerate_(n, n, 960, skipped)
    assert admitted and skipped
    assert all(schedule.persistent_fits(*t) for t in admitted)
    assert not any(schedule.persistent_fits(*t) for t in skipped)


def test_sweep_logs_the_pruned_candidates(cache_file, monkeypatch):
    calls, lines = [], []
    monkeypatch.setattr(tuning, "time_temporal_candidate", _fake(calls))
    params = LBMParams(128, 64, 960, 10, 0.1, 0.005, 1.85)
    results = tuning.autotune_sweep(params, channel_box(128, 64), log=lines.append)
    skipped = []
    cands = tuning.temporal_candidates(64, 128, 960, skipped)
    assert [c[:3] for c in calls] == cands and skipped
    assert any(ln.startswith(f"skipping {len(skipped)} candidate(s) whose window exceeds")
               for ln in lines)
    assert [r[3] for r in results] == sorted(r[3] for r in results)
    assert tuning.lookup(KIND, 64, 128)[0] == results[0][:3] + (results[0][4],)


def test_cli_autotune_dry_run(cache_file, monkeypatch, capsys):
    monkeypatch.setattr(tuning, "time_temporal_candidate", _fake())
    assert cli.main(["autotune", "--grid", "64x128", "--dry-run"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    payload = json.loads(out[-1])
    assert (payload["by"], payload["bx"], payload["k"]) == (32, 16, 16)
    assert payload["schedule"] == "temporal" and payload["us_per_step"] == 79.75
    assert out[-2] == ("best: (BY=32, BX=16, K=16) at 79.75 us/step = "
                       f"{64 * 128 / 79.75 / 1e3:.1f} GLUPS")
    assert not cache_file.exists()
    assert cli.main(["autotune", "--grid", "64x128"]) == 0
    capsys.readouterr()
    assert tuning.lookup(KIND, 64, 128)[0] == (32, 16, 16, "temporal")
    # The tool is the same entry point.
    assert autotune_tool.main(["--grid", "64x128", "--dry-run"]) == 0


def test_cli_autotune_checks(cache_file, monkeypatch):
    monkeypatch.setattr(tuning, "time_temporal_candidate", lambda *a, **k: None)
    for argv, msg in ((["--grid", "64x128", "--case", "128x128"], "exactly one"),
                      ([], "exactly one"), (["--grid", "64x128", "--steps", "0"], "--steps"),
                      (["--grid", "64x128", "--repeats", "0"], "--repeats"),
                      (["--grid", "64"], "--grid must be")):
        with pytest.raises(SystemExit, match=msg):
            cli.main(["autotune", *argv])
    # No candidate ran: exit 1.
    assert cli.main(["autotune", "--grid", "64x128"]) == 1


def test_the_timer_refuses_the_cpu_and_a_bad_schedule(monkeypatch):
    params = LBMParams(32, 16, 8, 10, 0.1, 0.005, 1.85)
    obstacles = channel_box(32, 16)
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    with pytest.raises(RuntimeError, match="on a CUDA device"):
        tuning.time_temporal_candidate(params, obstacles, 8, 16, 2, 8, 1)
    with pytest.raises(ValueError, match="schedule must be one of"):
        tuning.time_temporal_candidate(params, obstacles, 8, 16, 2, 8, 1, schedule="row")


def test_maybe_autotune_slab_opt_in(cache_file, monkeypatch):
    """Off by default; with LBM_AUTOTUNE_ON_MISS=1 a cache miss for a slab
    shape triggers a sweep whose winners land in the cache, restricted to
    the schedules given, and an existing entry suppresses re-sweeping."""
    calls = []
    monkeypatch.setattr(tuning, "time_temporal_candidate", _fake(calls))
    assert not tuning.maybe_autotune_slab(512, 4096, KIND)
    assert calls == [] and not cache_file.exists()
    monkeypatch.setenv("LBM_AUTOTUNE_ON_MISS", "1")
    assert tuning.maybe_autotune_slab(512, 4096, KIND)
    assert calls and all(s == "temporal" for *_, s in calls)
    assert tuning.lookup(KIND, 512, 4096)[0][3] == "temporal"
    calls.clear()
    assert not tuning.maybe_autotune_slab(512, 4096, KIND)
    assert calls == []
    # Both schedules where the caller can take the x-tiled route.
    assert tuning.maybe_autotune_slab(512, 8192, KIND, schedules=tuning.SCHEDULES)
    assert {s for *_, s in calls} == {"temporal", "xtiled"}
    # A shape whose sweep ran (even one that found nothing) is not swept
    # again in this process.
    monkeypatch.setattr(tuning, "time_temporal_candidate", lambda *a, **k: None)
    assert not tuning.maybe_autotune_slab(64, 64, KIND)
    assert not tuning.maybe_autotune_slab(64, 64, KIND)


def test_sharded_factories_autotune_the_slab(cache_file, monkeypatch):
    """The temporal factories ask for the slab shape's sweep, with the
    schedules their route can take (``lbm_tpu``'s sharded factories:
    row meshes and meshes of one column both, 2-D tiles the row kernel
    only); an explicit (BY, K) asks for none."""
    seen = []
    monkeypatch.setattr(tuning, "maybe_autotune_slab",
                        lambda ny, nx, kind, schedules=("temporal",), **kw:
                        seen.append((ny, nx, kind, schedules)))
    params = LBMParams(96, 64, 8, 10, 0.1, 0.005, 1.85)
    obstacles = channel_box(96, 64)
    fcinv = np.float32(1.0) / np.float32(free_cells_of(obstacles))
    row = Mesh([CPU, CPU], (AXIS,))
    sharded.make_sharded_temporal_run(params, obstacles, fcinv, row)
    sharded.make_sharded_temporal_2d_run(params, obstacles, fcinv,
                                         Mesh([[CPU, CPU], [CPU, CPU]], (AXIS, AXIS_X)))
    sharded.make_sharded_temporal_2d_run(params, obstacles, fcinv,
                                         Mesh([[CPU], [CPU]], (AXIS, AXIS_X)))
    assert seen == [(32, 96, KIND, tuning.SCHEDULES), (32, 48, KIND, ("temporal",)),
                    (32, 96, KIND, tuning.SCHEDULES)]
    seen.clear()
    sharded.make_sharded_temporal_run(params, obstacles, fcinv, row, by=8, ksteps=2)
    assert seen == []


def test_sharded_tile_reads_the_cache(cache_file):
    tuning.record(KIND, 32, 96, [(8, 32, 2, 1.0, "temporal")])
    assert sharded.choose_shard_temporal(32, 96, 8, device_kind=KIND) == (8, 32, 2)
    assert sharded.choose_shard_temporal(32, 96, 8, device_kind="other") == (32, 32, 4)


def test_record_stamps_provenance(cache_file):
    tuning.record(KIND, 64, 128, [(16, 32, 4, 51.0, "temporal")], steps=960, repeats=3)
    stamp = tuning.provenance_of(KIND, 64, 128)
    assert stamp.get("recorded") and "T" in stamp["recorded"]
    assert stamp.get("steps") == 960 and stamp.get("repeats") == 3
    assert "commit" in stamp
    tuning.record(KIND, 64, 256, [(8, 16, 2, 10.0, "temporal")])
    assert tuning.provenance_of(KIND, 64, 128) == stamp
    s2 = tuning.provenance_of(KIND, 64, 256)
    assert "recorded" in s2 and "steps" not in s2
    assert tuning.lookup(KIND, 64, 128) == [(16, 32, 4, "temporal")]
    assert tuning.provenance_of(KIND, 99, 99) == {}


def _refresh_case():
    params = LBMParams(128, 64, 960, 10, 0.1, 0.005, 1.85)
    return params, channel_box(params.nx, params.ny)


def test_refresh_incumbents_retimes_and_warns_on_drift(cache_file, monkeypatch):
    params, obstacles = _refresh_case()
    tuning.record(KIND, 64, 128, [(32, 64, 8, 40.0, "temporal"),
                                  (16, 32, 4, 50.0, "temporal")])
    timed = []

    def fake_time(params, obstacles, by, bx, k, steps, repeats, log=print,
                  schedule="temporal", storage=None):
        timed.append((by, bx, k))
        return {(32, 64, 8): 60.0, (16, 32, 4): 45.0}[(by, bx, k)]  # ranking flips

    monkeypatch.setattr(tuning, "time_temporal_candidate", fake_time)
    lines = []
    results = tuning.refresh_incumbents(params, obstacles, repeats=2, log=lines.append)
    assert sorted(timed) == [(16, 32, 4), (32, 64, 8)]
    assert results[0][:3] == (16, 32, 4)
    assert any("WARNING: winner changed" in ln for ln in lines)
    assert tuning.lookup(KIND, 64, 128)[0] == (16, 32, 4, "temporal")
    assert tuning.provenance_of(KIND, 64, 128).get("repeats") == 2
    p2 = LBMParams(512, 256, 960, 10, 0.1, 0.005, 1.85)
    assert tuning.refresh_incumbents(p2, channel_box(512, 256), log=lines.append) == []


def test_refresh_incumbents_timing_drift_and_dead_cache(cache_file, monkeypatch):
    params, obstacles = _refresh_case()
    tuning.record(KIND, 64, 128, [(32, 64, 8, 40.0, "temporal"),
                                  (16, 32, 4, 50.0, "temporal")])
    monkeypatch.setattr(
        tuning, "time_temporal_candidate",
        lambda p, o, by, bx, k, steps, repeats, log=print, schedule="temporal",
        storage=None: {(32, 64, 8): 60.0, (16, 32, 4): 75.0}[(by, bx, k)])
    lines = []
    results = tuning.refresh_incumbents(params, obstacles, repeats=2, log=lines.append)
    assert results[0][:3] == (32, 64, 8)
    assert any("winner timing drifted" in ln for ln in lines)
    assert not any("winner changed" in ln for ln in lines)
    monkeypatch.setattr(tuning, "time_temporal_candidate", lambda *a, **kw: None)
    lines.clear()
    assert tuning.refresh_incumbents(params, obstacles, log=lines.append) == []
    assert any("every incumbent failed" in ln for ln in lines)


def test_cli_autotune_refresh(cache_file, monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(tuning, "time_temporal_candidate", _fake(calls))
    tuning.record(KIND, 64, 128, [(16, 32, 4, 50.0, "temporal")])
    assert cli.main(["autotune", "--grid", "64x128", "--refresh"]) == 0
    assert calls == [(16, 32, 4, "temporal")]
    assert "falling back" not in capsys.readouterr().out
    calls.clear()
    assert cli.main(["autotune", "--grid", "64x256", "--refresh"]) == 0
    assert "falling back to a full sweep" in capsys.readouterr().out
    assert len(calls) > 1 and tuning.lookup(KIND, 64, 256)
    # --refresh --dry-run re-times and writes nothing.
    before = cache_file.read_bytes()
    assert cli.main(["autotune", "--grid", "64x128", "--refresh", "--dry-run"]) == 0
    assert cache_file.read_bytes() == before


def test_cached_pick_runs_like_lbm_tpu(cache_file, monkeypatch):
    """A cache-driven tile steers performance, never results: the
    Simulator that takes it matches lbm_tpu's run (f atol 1e-6, av rtol
    1e-4, as tests/test_torch_temporal.py)."""
    monkeypatch.setattr(schedule, "MULTISTEP_CELL_BUDGET", 0)
    params, obstacles, f0 = gate_case(32, 48, 97)
    params = dataclasses.replace(params, max_iters=8)
    tuning.record(KIND, 32, 48, [(8, 16, 2, 10.0, "temporal")])
    sim = Simulator(params, obstacles, device=CPU)
    prog = sim.program
    assert isinstance(prog, fused.TemporalStep)
    assert (prog.by, prog.bx, prog.chunk) == (8, 16, 2) != schedule.fixed_temporal(32, 48, 8)
    ours = sim.run(f0=f0, readback="state")
    theirs = lbm_tpu.Simulator(lbm_tpu.LBMParams(**dataclasses.asdict(params)), obstacles,
                               kernel="reference").run(f0=jnp.asarray(f0), readback="state")
    np.testing.assert_allclose(ours.f, np.asarray(theirs.f), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours.av_vels, theirs.av_vels, rtol=1e-4)


def test_the_port_never_reads_lbm_tpu_cache(monkeypatch):
    monkeypatch.delenv("LBM_TUNING_CACHE", raising=False)
    assert tuning.cache_path().parent.name == "lbm_tpu_torch"
    assert tuning.cache_path() != jax_tuning.cache_path()
    shipped = json.loads(jax_tuning.cache_path().read_text())
    key = next(k for k in shipped if k != jax_tuning.META_KEY)
    kind, shape = key.split("|")
    ny, nx = (int(v) for v in shape.split("x"))
    assert jax_tuning.lookup(kind, ny, nx)
    assert tuning.lookup(kind, ny, nx) == []


def _projected(order):
    """The (by, k) order of a ranking, first occurrence of each."""
    out = []
    for by, k in order:
        if (by, k) not in out:
            out.append((by, k))
    return out


def test_same_rankings_and_warnings_as_lbm_tpu(tmp_path, monkeypatch):
    """The same stubbed timings, a function of (BY, K), through both
    packages' ``autotune_sweep`` and ``refresh_incumbents``: the (BY, K)
    both sweep rank alike, and a refresh warns alike."""
    port_cache, jax_cache = tmp_path / "port.json", tmp_path / "jax.json"
    times = lambda by, k: 100.0 - by / 8 - k  # noqa: E731
    monkeypatch.setattr(tuning, "time_temporal_candidate",
                        lambda p, o, by, bx, k, *a, **kw: times(by, k))
    monkeypatch.setattr(jax_tuning, "time_temporal_candidate",
                        lambda p, o, by, k, *a, **kw: times(by, k))
    params = LBMParams(256, 128, 960, 10, 0.1, 0.005, 1.85)
    obstacles = channel_box(256, 128)
    jparams = lbm_tpu.LBMParams(**dataclasses.asdict(params))
    monkeypatch.setenv("LBM_TUNING_CACHE", str(port_cache))
    ours = tuning.autotune_sweep(params, obstacles, log=lambda s: None)
    monkeypatch.setenv("LBM_TUNING_CACHE", str(jax_cache))
    theirs = jax_tuning.autotune_sweep(jparams, obstacles, log=lambda s: None,
                                       schedules=("row",))
    common = {(r[0], r[1]) for r in theirs} & {(r[0], r[2]) for r in ours}
    assert len(common) >= 5
    assert ([bk for bk in _projected((r[0], r[2]) for r in ours) if bk in common]
            == [bk for bk in _projected((r[0], r[1]) for r in theirs) if bk in common])

    # Refresh: the same incumbents, the same new timings, the same warnings.
    incumbents = [(32, 8, 40.0), (16, 4, 50.0)]
    for new, warning in (({(32, 8): 60.0, (16, 4): 45.0}, "winner changed"),
                         ({(32, 8): 60.0, (16, 4): 75.0}, "winner timing drifted"),
                         ({}, "every incumbent failed")):
        monkeypatch.setattr(tuning, "time_temporal_candidate",
                            lambda p, o, by, bx, k, *a, new=new, **kw: new.get((by, k)))
        monkeypatch.setattr(jax_tuning, "time_temporal_candidate",
                            lambda p, o, by, k, *a, new=new, **kw: new.get((by, k)))
        logs = {}
        monkeypatch.setenv("LBM_TUNING_CACHE", str(port_cache))
        tuning.record(tuning.default_device_kind(), 128, 256,
                      [(by, 64, k, us, "temporal") for by, k, us in incumbents])
        logs["port"] = []
        ours = tuning.refresh_incumbents(params, obstacles, log=logs["port"].append)
        monkeypatch.setenv("LBM_TUNING_CACHE", str(jax_cache))
        jax_tuning.record(jax_tuning.default_device_kind(), 128, 256, incumbents)
        logs["jax"] = []
        theirs = jax_tuning.refresh_incumbents(jparams, obstacles, log=logs["jax"].append)
        assert [(r[0], r[2]) for r in ours] == [(r[0], r[1]) for r in theirs]
        for name in ("port", "jax"):
            warned = [w for w in ("winner changed", "winner timing drifted",
                                  "every incumbent failed")
                      if any(w in ln for ln in logs[name])]
            assert warned == [warning], (name, logs[name])

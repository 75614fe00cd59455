"""Measured kernel-tuning cache (per device kind / grid shape).

The port of ``lbm_tpu.tuning``.  The reference tuned its OpenCL workgroup
geometry by hand per grid (its "workgroup tuning" ladder stage).  The
Hopper analog is the temporal kernel's tile and K: the chooser
(:mod:`lbm_tpu_torch.ops.schedule`) ships a fixed preference order
measured at one grid, and this module adds the production path —
``lbm autotune`` (``python -m lbm_tpu_torch.cli autotune``,
``python -m lbm_tpu_torch.tools.autotune``) *measures* the candidates on
the card and records the winners here, so any grid shape (not just the
four canonical cases) runs at its measured-best configuration.

Cache format (JSON)::

    {"<device name>|<ny>x<nx>": [[by, bx, k, us_per_step, schedule], ...]}

best first; ``schedule`` is ``"temporal"`` (the row temporal kernel,
ping-pong f) or ``"xtiled"`` (the in-place x-tiled kernel).  The tile is
2-D on Hopper, so an entry carries BY and BX and no strip count.  The
device name is ``torch.cuda.get_device_name()``.

Lookup order in the chooser (``schedule.choose_temporal`` /
``choose_schedule`` / ``choose_temporal_xtiled``): the first cache entry
whose tile and K the kernel takes (the tile divides the grid, K divides
``max_iters``, the window fits a block's shared memory), then the fixed
order.  The file is ``LBM_TUNING_CACHE`` or else
``lbm_tpu_torch/tuning_cache.json``; the port never reads
``lbm_tpu/tuning_cache.json``, whose entries are another device's.  A
missing or corrupt file disables the cache — tuning is an accelerator,
never a correctness dependency.

Absolute vs comparable timings: a sweep times every candidate with the
same loop of launches, so the host's per-launch cost (a few µs a
launch) weighs on every entry alike at equal K — rankings hold, but the
stored µs are those of a bound loop of ``steps`` steps, not of a full
run.  Use long loops when an absolute number matters.

Staleness: cached entries outrank the fixed order by design, so a kernel
change can silently inherit timings measured on the old kernel.  Two
guards: (1) every :func:`record` stamps per-key provenance (UTC date,
repo commit when available, sweep steps/repeats) under the top-level
``"__meta__"`` key, so a reviewer can see when and at what commit an
entry was measured; (2) ``lbm autotune --refresh``
(:func:`refresh_incumbents`) re-times only the recorded candidates,
re-records them with fresh timings and provenance, and warns when the
ranking changed or the winner drifted, the signal to re-run the full
sweep.
"""

from __future__ import annotations

import functools
import json
import os
import pathlib
import tempfile

import numpy as np
import torch

_DEFAULT_PATH = pathlib.Path(__file__).parent / "tuning_cache.json"
SCHEDULES = ("temporal", "xtiled")
META_KEY = "__meta__"


def cache_path() -> pathlib.Path:
    return pathlib.Path(os.environ.get("LBM_TUNING_CACHE", _DEFAULT_PATH))


def _key(device_kind: str, ny: int, nx: int) -> str:
    return f"{device_kind}|{ny}x{nx}"


@functools.lru_cache(maxsize=8)
def _load(path_str: str, mtime: float) -> dict:
    del mtime  # cache-buster: reload when the file changes
    try:
        with open(path_str) as fp:
            data = json.load(fp)
        return data if isinstance(data, dict) else {}
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return {}


def load_cache() -> dict:
    """The parsed cache ({} when absent/corrupt); reloaded on file change."""
    path = cache_path()
    try:
        mtime = path.stat().st_mtime
    except OSError:
        return {}
    return _load(str(path), mtime)


def _entries(device_kind: str, ny: int, nx: int) -> list[tuple[int, int, int, float, str]]:
    """The well-formed entries recorded for this device/grid, in file
    order: ``(by, bx, k, us_per_step, schedule)``."""
    entries = load_cache().get(_key(device_kind, ny, nx), [])
    if not isinstance(entries, list):
        return []
    out = []
    for e in entries:
        # Tolerate malformed entries (hand-edited cache files): the cache
        # is an accelerator, never a correctness dependency.
        try:
            if isinstance(e, (list, tuple)) and len(e) == 5 and e[4] in SCHEDULES:
                out.append((int(e[0]), int(e[1]), int(e[2]), float(e[3]), e[4]))
        except (TypeError, ValueError, OverflowError):
            continue
    return out


def lookup(device_kind: str, ny: int, nx: int) -> list[tuple[int, int, int, str]]:
    """Ranked measured ``(by, bx, k, schedule)`` candidates for this
    device/grid (best first); [] when the cache has no entry."""
    return [(by, bx, k, sched) for by, bx, k, _, sched in _entries(device_kind, ny, nx)]


def _provenance(steps: int | None, repeats: int | None) -> dict:
    """Per-key measurement provenance: when, at what repo commit (None
    when the package is not inside a git checkout), and how the timing
    was taken.  Stamped by :func:`record` so a stale entry is at least
    visibly stale (module docstring: the staleness story)."""
    import datetime
    import subprocess

    commit = None
    try:
        out = subprocess.run(
            ["git", "-C", str(pathlib.Path(__file__).parent), "rev-parse", "--short",
             "HEAD"],
            capture_output=True, text=True, timeout=5,
        )
        if out.returncode == 0:
            commit = out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        pass
    meta = {
        "recorded": datetime.datetime.now(datetime.timezone.utc).isoformat(
            timespec="seconds"),
        "commit": commit,
    }
    if steps is not None:
        meta["steps"] = int(steps)
    if repeats is not None:
        meta["repeats"] = int(repeats)
    return meta


def provenance_of(device_kind: str, ny: int, nx: int) -> dict:
    """The provenance stamp recorded with this device/grid's entries ({}
    for no entry)."""
    meta = load_cache().get(META_KEY, {})
    if not isinstance(meta, dict):
        return {}
    entry = meta.get(_key(device_kind, ny, nx), {})
    return entry if isinstance(entry, dict) else {}


def record(device_kind: str, ny: int, nx: int, results: list[tuple],
           steps: int | None = None, repeats: int | None = None) -> pathlib.Path:
    """Store measured ``(by, bx, k, us_per_step, schedule)`` results
    (sorted fastest first) for this device/grid, merging with existing
    entries for other keys, and stamp the key's provenance under
    ``"__meta__"`` (date / commit / sweep ``steps`` / ``repeats``).
    Atomic write."""
    path = cache_path()
    cache = dict(load_cache())
    key = _key(device_kind, ny, nx)
    for r in results:
        if r[4] not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}, got {r[4]!r}")
    cache[key] = [[int(r[0]), int(r[1]), int(r[2]), round(float(r[3]), 3), r[4]]
                  for r in sorted(results, key=lambda r: r[3])]
    # Copy before mutating: load_cache() returns the lru-cached dict.
    meta = cache.get(META_KEY, {})
    meta = dict(meta) if isinstance(meta, dict) else {}
    meta[key] = _provenance(steps, repeats)
    cache[META_KEY] = meta
    path.parent.mkdir(parents=True, exist_ok=True)
    # Unique temp name: two concurrent sweeps (different grids, one host)
    # must not collide on a shared .tmp sibling; last-rename-wins is then
    # the only race left, and it loses at most the other sweep's single
    # merge (acceptable for a rare, re-runnable measurement write).
    fd, tmp_name = tempfile.mkstemp(dir=path.parent, prefix=path.name + ".",
                                    suffix=".tmp")
    with os.fdopen(fd, "w") as fp:
        fp.write(json.dumps(cache, indent=1, sort_keys=True) + "\n")
    pathlib.Path(tmp_name).replace(path)
    return path


# (device_kind, ny, nx) shapes maybe_autotune_slab already swept this
# process — never repeat a sweep.
_ATTEMPTED_SWEEPS: set[tuple[str, int, int]] = set()


def autotune_on_miss_enabled() -> bool:
    """Opt-in switch (``LBM_AUTOTUNE_ON_MISS=1``) for measuring a slab
    shape's tile and K on first use instead of trusting the fixed order.
    Off by default: a sweep costs seconds to minutes of card time."""
    return os.environ.get("LBM_AUTOTUNE_ON_MISS", "").lower() in ("1", "true", "yes")


def maybe_autotune_slab(ny: int, nx: int, device_kind: str, steps: int = 240,
                        repeats: int = 2, log=None,
                        schedules: tuple[str, ...] = ("temporal",)) -> bool:
    """When ``LBM_AUTOTUNE_ON_MISS=1`` and the cache has no entry for this
    device/shape, run a short measured sweep on a proxy grid of that shape
    and record the winners (so the chooser's lookup that follows hits the
    fresh entry).  Returns True when a sweep ran and recorded at least one
    result.

    The sharded temporal factories call this with the local slab shape
    (``nyl x nx`` of a row mesh, ``nyl x nxl`` of a 2-D tile): the shard
    kernel runs the single-device temporal window on the slab, so a
    single-device sweep of the slab shape measures the per-shard schedule.
    Proxy geometry: an empty channel box — obstacle placement does not
    change the kernel's timing (the same masked algebra either way).

    Recording uses :func:`default_device_kind` (the device the sweep ran
    on); callers pass the mesh's kind only to check the cache.  To keep a
    mismatch (or a sweep whose every candidate failed) from re-paying the
    sweep on every run, the cache is also checked under the measuring
    device's kind and each (kind, shape) is attempted at most once per
    process.  ``schedules`` says which entries the caller can consume: a
    1-D row mesh (or a 2-D mesh of one column) takes the x-tiled route
    too, a 2-D tile only the temporal kernel.
    """
    if not autotune_on_miss_enabled():
        return False
    if device_kind and lookup(device_kind, ny, nx):
        return False  # already measured
    measuring = default_device_kind()
    if measuring != device_kind and lookup(measuring, ny, nx):
        return False  # measured on the device the sweep would run on
    attempt = (measuring, ny, nx)
    if attempt in _ATTEMPTED_SWEEPS:
        return False  # this process already swept (or failed) this shape
    _ATTEMPTED_SWEEPS.add(attempt)
    from lbm_tpu_torch.config import LBMParams
    from lbm_tpu_torch.geometry import channel_box

    if log is None:
        log = _print_flush
    log(f"LBM_AUTOTUNE_ON_MISS: no measured tile for {device_kind or 'device'}|"
        f"{ny}x{nx} — sweeping (steps={steps})")
    params = LBMParams(nx, ny, steps, 10, 0.1, 0.005, 1.85)
    results = autotune_sweep(params, channel_box(nx, ny), steps=steps, repeats=repeats,
                             log=log, schedules=schedules)
    return bool(results)


def device_kind(device: torch.device) -> str:
    """The cache's name for ``device``: ``torch.cuda.get_device_name`` of a
    CUDA device, ``"cpu"`` for the CPU."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def default_device_kind() -> str:
    """The name of the current CUDA device, or ``"cpu"`` without one."""
    if torch.cuda.is_available():
        return device_kind(torch.device("cuda", torch.cuda.current_device()))
    return "cpu"


# -- measurement (the autotuner core; CLI surfaces: `lbm autotune` and
# -- lbm_tpu_torch/tools/autotune.py) ------------------------------------------

TILE_ROWS = (8, 16, 32, 64, 128)
TILE_COLS = (16, 32, 64, 128, 256)
CANDIDATE_K = (2, 4, 8, 16)


def temporal_candidates(ny: int, nx: int, steps: int,
                        skipped: list | None = None) -> list[tuple[int, int, int]]:
    """(by, bx, K) sweep candidates of the row temporal kernel: by in
    :data:`TILE_ROWS` and bx in :data:`TILE_COLS` dividing the grid, K in
    :data:`CANDIDATE_K` dividing ``steps``, the persistent kernel's
    windows within a block's shared memory (``schedule.persistent_fits``).
    Candidates the budget prunes are appended to ``skipped`` (when given),
    so a sweep can report them instead of silently narrowing."""
    from lbm_tpu_torch.ops import schedule

    cands = []
    for by in TILE_ROWS:
        for bx in TILE_COLS:
            if ny % by or nx % bx:
                continue
            for k in CANDIDATE_K:
                if steps % k:
                    continue
                if schedule.persistent_fits(by, bx, k):
                    cands.append((by, bx, k))
                elif skipped is not None:
                    skipped.append((by, bx, k))
    return cands


def xtiled_candidates(ny: int, nx: int, steps: int,
                      skipped: list | None = None) -> list[tuple[int, int, int]]:
    """(by, bx, K) sweep candidates of the x-tiled kernel: the temporal
    kernel's (both are persistent passes with one footprint), under
    ``lbm_tpu``'s x-tiled gate (nx >= ``schedule.XTILED_MIN_NX``, ny >=
    ``XTILED_MIN_NY``, strips ``schedule.xtiled_strips``).  They meet the
    kernel's constraints (``schedule.xtiled_structurally_valid``) by
    construction; budget-pruned ones go to ``skipped``."""
    from lbm_tpu_torch.ops import schedule

    if (nx < schedule.XTILED_MIN_NX or ny < schedule.XTILED_MIN_NY
            or not schedule.xtiled_strips(nx)):
        return []
    return temporal_candidates(ny, nx, steps, skipped)


# Progress lines must land immediately even when stdout is piped.
_print_flush = functools.partial(print, flush=True)


def time_temporal_candidate(params, obstacles, by: int, bx: int, k: int, steps: int,
                            repeats: int, log=_print_flush, schedule: str = "temporal",
                            storage: torch.dtype | None = None) -> float | None:
    """Best-of-``repeats`` µs/step for one (by, bx, K) of the row temporal
    kernel (``schedule="temporal"``) or the x-tiled kernel (``"xtiled"``)
    on the card, or None where the program refuses the tile or the card
    refuses the launch (a sweep logs and moves on).  ``storage`` sets the
    dtype of f (the 16-bit-storage experiment; the row schedule only — the
    x-tiled kernel is fp32-storage).

    Timing: one warm-up loop, then ``repeats`` loops of ``steps // k``
    launches bound once, each timed by CUDA events around the loop; the
    best, per step.  The device is :func:`runtime.select_device`'s; on a
    CPU device this raises (there is no card to time).  A failed build
    raises too: it is never a sweep miss."""
    from lbm_tpu_torch.geometry import free_cells_of
    from lbm_tpu_torch.ops import _build
    from lbm_tpu_torch.ops.fused import TemporalStep, TemporalXtStep
    from lbm_tpu_torch.ops.reference import init_cells
    from lbm_tpu_torch.runtime import select_device

    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, got {schedule!r}")
    if schedule == "xtiled" and storage is not None and storage != torch.float32:
        # A caller error, not a sweep miss — raise instead of the None
        # the sweep-candidate failures return.
        raise ValueError("storage override requires the row-blocked schedule "
                         "(px == 1); the x-tiled kernel is fp32-storage")
    device = select_device()
    if device.type != "cuda":
        raise RuntimeError(f"the autotuner times kernels on a CUDA device, not {device}")
    fcinv = np.float32(1.0) / np.float32(free_cells_of(obstacles))
    try:
        if schedule == "xtiled":
            prog = TemporalXtStep(params, obstacles, fcinv, device, by, bx, k)
        else:
            prog = TemporalStep(params, obstacles, fcinv, device, by, bx, k,
                                storage=storage or torch.float32)
    except ValueError as e:
        log(f"      [ValueError: {str(e).splitlines()[0][:100]}]")
        return None
    launches = steps // k
    try:
        with torch.cuda.device(device):
            f0 = init_cells(params, device).to(prog.storage)
            bufs = [f0] + [torch.empty_like(f0) for _ in range(prog.n_buffers - 1)]
            av = torch.empty(launches * k, dtype=torch.float32, device=device)
            launch = prog.bind(*bufs, av)
            for i in range(launches):  # warm-up
                launch(i)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            best = float("inf")
            for _ in range(repeats):
                start.record()
                for i in range(launches):
                    launch(i)
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end))
        return best * 1e3 / (launches * k)
    except _build.BuildError:
        raise
    except RuntimeError as e:  # a refused launch or no room: log and move on
        log(f"      [{type(e).__name__}: {str(e).splitlines()[0][:100]}]")
        return None


def _tag(schedule: str) -> str:
    return ", x-tiled" if schedule == "xtiled" else ""


def autotune_sweep(params, obstacles, steps: int = 960, repeats: int = 3,
                   record_results: bool = True, log=_print_flush,
                   schedules: tuple[str, ...] = SCHEDULES,
                   ) -> list[tuple[int, int, int, float, str]]:
    """Measure every candidate — the row temporal kernel's (by, bx, K)
    and, where ``lbm_tpu``'s gate admits the grid, the x-tiled kernel's —
    for this grid on the card and (optionally) record the ranked results
    in the cache.  Returns measured ``(by, bx, k, us_per_step, schedule)``
    sorted fastest first ([] when nothing ran).  ``schedules`` restricts
    the pool to what the caller can consume."""
    from lbm_tpu_torch.ops import schedule as sched

    ny, nx = params.ny, params.nx
    kind = default_device_kind()
    pruned: list[tuple] = []
    cands = []
    if "temporal" in schedules:
        cands += [(*c, "temporal") for c in temporal_candidates(ny, nx, steps, pruned)]
    if "xtiled" in schedules:
        pruned_xt: list[tuple] = []
        cands += [(*c, "xtiled") for c in xtiled_candidates(ny, nx, steps, pruned_xt)]
        pruned += [(*c, "xtiled") for c in pruned_xt]
    if pruned:
        # No silent caps: say what the shared-memory budget left out.
        log(f"skipping {len(pruned)} candidate(s) whose window exceeds a block's "
            f"shared memory ({sched.PERSISTENT_SMEM_BUDGET} bytes for the temporal "
            f"and x-tiled kernels' persistent pass): "
            + ", ".join(f"(BY={c[0]}, BX={c[1]}, K={c[2]}"
                        + (_tag(c[3]) if len(c) > 3 else "") + ")" for c in pruned))
    if not cands:
        log(f"no temporal candidates for {ny}x{nx}")
        return []
    log(f"device kind: {kind}; grid {ny}x{nx}; {len(cands)} candidates")
    results = []
    for by, bx, k, s in cands:
        us = time_temporal_candidate(params, obstacles, by, bx, k, steps, repeats,
                                     log=log, schedule=s)
        status = f"{us:8.2f} us/step" if us is not None else "   failed/skipped"
        log(f"  (BY={by:4d}, BX={bx:4d}, K={k:2d}{_tag(s)}): {status}")
        if us is not None:
            results.append((by, bx, k, us, s))
    results.sort(key=lambda r: r[3])
    if results and record_results:
        path = record(kind, ny, nx, results, steps=steps, repeats=repeats)
        log(f"recorded {len(results)} entries -> {path}")
    return results


def refresh_incumbents(params, obstacles, steps: int = 960, repeats: int = 3,
                       record_results: bool = True, log=_print_flush,
                       drift_warn_pct: float = 25.0,
                       ) -> list[tuple[int, int, int, float, str]]:
    """Re-time only the candidates already recorded for this device/grid
    (the ``lbm autotune --refresh`` path), re-record them with fresh
    timings and provenance, and warn when the incumbent ranking changed or
    the winner's timing drifted more than ``drift_warn_pct`` — the
    stale-cache signal that a kernel change invalidated the old
    measurements and a full sweep is due.  Returns the re-measured results
    fastest first, or [] when the cache has no entry for this shape
    (callers fall back to the full sweep)."""
    ny, nx = params.ny, params.nx
    kind = default_device_kind()
    recorded = _entries(kind, ny, nx)
    if not recorded:
        log(f"no recorded entries for {kind}|{ny}x{nx} — nothing to refresh")
        return []
    stamp = provenance_of(kind, ny, nx)
    log(f"refreshing {len(recorded)} recorded candidate(s) for {kind}|{ny}x{nx}"
        + (f" (recorded {stamp.get('recorded')}"
           + (f" at {stamp['commit']}" if stamp.get("commit") else "") + ")"
           if stamp else " (no provenance stamp)"))
    was_us = {(by, bx, k, s): us for by, bx, k, us, s in recorded}
    results = []
    for by, bx, k, _, s in recorded:
        us = time_temporal_candidate(params, obstacles, by, bx, k, steps, repeats,
                                     log=log, schedule=s)
        was = was_us[(by, bx, k, s)]
        drift = (f" (was {was:.2f}, {(us - was) / was * 100.0:+.1f}%)"
                 if us is not None and was else "")
        status = f"{us:8.2f} us/step{drift}" if us is not None else "   failed"
        log(f"  (BY={by:4d}, BX={bx:4d}, K={k:2d}{_tag(s)}): {status}")
        if us is not None:
            results.append((by, bx, k, us, s))
    results.sort(key=lambda r: r[3])
    if not results:
        log("every incumbent failed to run — the cache is stale for the current "
            "kernels; run a full sweep (lbm autotune without --refresh)")
        return []
    new = results[0][:3] + results[0][4:]
    old = recorded[0][:3] + recorded[0][4:]
    if new != old:
        log(f"WARNING: winner changed (BY={old[0]}, BX={old[1]}, K={old[2]}"
            f"{_tag(old[3])}) -> (BY={new[0]}, BX={new[1]}, K={new[2]}{_tag(new[3])}) "
            "— the recorded ranking was stale; consider a full sweep to re-check "
            "candidates outside the incumbent set")
    else:
        was, nus = was_us[recorded[0][:3] + recorded[0][4:]], results[0][3]
        if was and abs(nus - was) / was * 100.0 > drift_warn_pct:
            log(f"WARNING: winner timing drifted {(nus - was) / was * 100.0:+.1f}% vs "
                f"the recorded {was:.2f} us/step — kernels or platform changed since "
                "the sweep; consider a full sweep")
    if record_results:
        path = record(kind, ny, nx, results, steps=steps, repeats=repeats)
        log(f"re-recorded {len(results)} entries -> {path}")
    return results

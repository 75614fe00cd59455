"""The temporal program with f stored in 16 bits (``TemporalStep(storage=
torch.float16 / torch.bfloat16)``) against lbm_tpu's
``_step_kernel_temporal`` with ``storage=`` (``build_temporal_program(...,
storage=..., interpret=True)``, as ``tests/test_fused.py`` runs it), the
plain version's definition, the buffers' dtype, the refusals, its grid,
and its refusal to fall back.

On the CPU the program runs its plain version: f widened to fp32, the
fp32 window pass, the new f rounded to nearest even.  The CUDA kernel
(``csrc/lbm_temporal16.cu``, a persistent pass) is held against that plain
version on the card by ``chip_smoke.py``; here an emulation of its walk
(each window staged in 16 bits chunk by chunk, at the copy width the C
entry picks, the first step reading it widened) is held against the plain
version, bitwise in f and av within 1e-6 relative (tiles add in walk
order).
Tolerances of one pass against lbm_tpu's on the same input: f within one
ulp of the storage type (the two packages' fp32 passes may differ in the
last fp32 bits, which can move a rounding by one 16-bit step), av rtol
1e-4 (av comes from the fp32 window, summed in another order).
"""

import contextlib
import ctypes
import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbm_tpu
from lbm_tpu.ops.fused import build_temporal_program
from lbm_tpu.ops.reference import init_cells as jax_init_cells
from lbm_tpu_torch import tuning
from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.geometry import channel_box, free_cells_of
from lbm_tpu_torch.ops import _build, fused, schedule
from lbm_tpu_torch.testing import gate_case
from lbm_tpu_torch.tools import fp16_experiment

AV_RTOL = 1e-4
CPU = torch.device("cpu")
STORAGES = [(torch.float16, jnp.float16), (torch.bfloat16, jnp.bfloat16)]
IDS = ["float16", "bfloat16"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The grids here are small, and the suite runs in parallel workers:
    intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def empty_tuning_cache(tmp_path, monkeypatch):
    """The chooser reads no measured entry here."""
    monkeypatch.setenv("LBM_TUNING_CACHE", str(tmp_path / "none.json"))


def _setup(ny, nx, seed):
    params, obstacles, f0 = gate_case(ny, nx, seed)
    fcinv = np.float32(1.0) / np.float32(free_cells_of(obstacles))
    return params, obstacles, f0, fcinv


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in 16-bit steps between two tensors of the
    same 16-bit dtype holding positive values (f is positive here)."""
    assert a.dtype == b.dtype and a.element_size() == 2
    assert bool((a > 0).all()) and bool((b > 0).all())
    return int((a.view(torch.int16).int() - b.view(torch.int16).int()).abs().max())


@pytest.mark.parametrize("storage, jax_storage", STORAGES, ids=IDS)
def test_plain_16bit_pass_matches_pallas_kernel(storage, jax_storage):
    """32x48, three passes of K = 4 from one seeded f0: JAX's 8-row blocks
    against the port's 8x16 tiles; row ny-2 = 30 lies in the top tile
    row's interior and, wrapped, in the bottom row's south halo.  Each of
    the port's passes starts from JAX's state, so each pass is held on the
    same input: a rounding moved by one step in one pass would otherwise
    feed the next and grow, which says nothing about the pass."""
    params, obstacles, f0, fcinv = _setup(32, 48, seed=91)
    program = build_temporal_program(params, obstacles, fcinv, by=8, ksteps=4,
                                     interpret=True, storage=jax_storage)
    jstep = jax.jit(program.step)
    carry = program.init(jnp.asarray(f0))
    assert carry[0].dtype == jax_storage
    ours = fused.TemporalStep(params, obstacles, fcinv, CPU, by=8, bx=16, ksteps=4,
                              storage=storage)
    f = torch.from_numpy(f0).to(storage)
    np.testing.assert_array_equal(f.float().numpy(), np.asarray(carry[0], np.float32))
    launches = dict(fused.LAUNCHES)
    for _ in range(3):
        bufs = (f, torch.empty_like(f))
        av = torch.empty(4, dtype=torch.float32)
        ours.bind(*bufs, av)(0)
        carry, jav = jstep(carry)
        np.testing.assert_allclose(av.numpy(), np.asarray(jav), rtol=AV_RTOL)
        theirs = torch.from_numpy(np.asarray(program.final(carry))).to(storage)
        assert _ulps(bufs[1], theirs) <= 1
        f = theirs
    assert fused.LAUNCHES == launches  # the CPU path launches nothing


@pytest.mark.parametrize("storage", [s for s, _ in STORAGES], ids=IDS)
def test_plain_16bit_pass_is_the_rounded_fp32_pass(storage):
    params, obstacles, f0, fcinv = _setup(24, 40, seed=92)
    p16 = fused.TemporalStep(params, obstacles, fcinv, CPU, 8, 8, 3, storage=storage)
    p32 = fused.TemporalStep(params, obstacles, fcinv, CPU, 8, 8, 3)
    f = torch.from_numpy(f0).to(storage)
    out16, av16 = p16.plain_launch(f)
    out32, av32 = p32.plain_launch(f.float())
    assert out16.dtype == storage
    assert torch.equal(out16, out32.to(storage))
    assert torch.equal(av16, av32)  # av from the fp32 window, before rounding


def test_float32_storage_is_the_fp32_program():
    params, obstacles, f0, fcinv = _setup(24, 40, seed=93)
    default = fused.TemporalStep(params, obstacles, fcinv, CPU, 8, 8, 2)
    explicit = fused.TemporalStep(params, obstacles, fcinv, CPU, 8, 8, 2,
                                  storage=torch.float32)
    assert default.storage == explicit.storage == torch.float32
    assert default.bytes_per_update == explicit.bytes_per_update
    f = torch.from_numpy(f0)
    runs = []
    for prog in (default, explicit):
        bufs = (f.clone(), torch.empty_like(f))
        av = torch.empty(6, dtype=torch.float32)
        launch = prog.bind(*bufs, av)
        for i in range(3):
            launch(i)
        runs.append((bufs[prog.final_index(3)], av))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("storage", [s for s, _ in STORAGES], ids=IDS)
def test_buffers_hold_the_storage_dtype(storage):
    params, obstacles, f0, fcinv = _setup(16, 24, seed=94)
    prog = fused.TemporalStep(params, obstacles, fcinv, CPU, 8, 8, 2, storage=storage)
    f = torch.from_numpy(f0).to(storage)
    bufs = (f.clone(), torch.empty_like(f))
    av = torch.empty(4, dtype=torch.float32)
    launch = prog.bind(*bufs, av)
    launch(0)
    launch(1)
    assert bufs[0].dtype == bufs[1].dtype == storage and av.dtype == torch.float32
    one, one_av = prog.single(f)
    assert one.dtype == storage and one_av.dtype == torch.float32
    assert torch.equal(one, prog.plain_launch(f)[0])
    # Half the f bytes of the fp32 pass: 9 two-byte populations a cell.
    assert prog.bytes_per_update == fused.window_bytes_per_update(8, 8, 2, 2)
    assert fused.window_bytes_per_update(8, 8, 2, 2) == (12 * 12 * 19 + 64 * 18) / 128


def test_refusals():
    params, obstacles, f0, fcinv = _setup(16, 24, seed=95)
    with pytest.raises(ValueError, match="storage must be one of"):
        fused.TemporalStep(params, obstacles, fcinv, CPU, 8, 8, 2, storage=torch.float64)
    prog = fused.TemporalStep(params, obstacles, fcinv, CPU, 8, 8, 2,
                              storage=torch.float16)
    f = torch.from_numpy(f0)
    with pytest.raises(ValueError, match="must be torch.float16"):
        prog.bind(f, torch.empty_like(f), torch.empty(2))
    # 8x256 at K 2: the persistent pass's windows fit no block, in every
    # storage type, raised before the library is built.
    p2, o2, _, fc2 = _setup(16, 512, seed=97)
    assert not schedule.persistent_fits(8, 256, 2)

    def no_build():
        raise AssertionError("built the library before refusing the tile")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_build, "load_library", no_build)
        for storage in (torch.float16, torch.bfloat16):
            for dev in (CPU, torch.device("cuda", 0)):
                with pytest.raises(ValueError, match="shared memory"):
                    fused.TemporalStep(p2, o2, fc2, dev, 8, 256, 2, storage=storage)
    # The x-tiled kernel is fp32-storage: lbm_tpu's refusal, raised before
    # any device is asked for.
    with pytest.raises(ValueError, match="the x-tiled kernel is fp32-storage"):
        tuning.time_temporal_candidate(params, obstacles, 8, 8, 2, 4, 1,
                                       schedule="xtiled", storage=torch.bfloat16)


@pytest.mark.parametrize("storage", [s for s, _ in STORAGES], ids=IDS)
def test_temporal_never_takes_the_plain_path_on_other_devices(storage, monkeypatch):
    params, obstacles, f0, fcinv = _setup(8, 12, seed=96)
    prog = fused.TemporalStep(params, obstacles, fcinv, CPU, by=4, bx=4, ksteps=2,
                              storage=storage)

    def no_plain(*args, **kwargs):
        raise AssertionError("the CUDA path fell back to the plain version")

    monkeypatch.setattr(prog, "plain_launch", no_plain)
    monkeypatch.setattr(prog, "plain", no_plain)
    f = torch.empty(f0.shape, dtype=storage, device="meta")
    av = torch.empty(2, device="meta")

    def failing_build():
        raise _build.BuildError("simulated build failure")

    monkeypatch.setattr(_build, "load_library", failing_build)
    with pytest.raises(_build.BuildError, match="simulated"):
        prog.bind(f, torch.empty_like(f), av)
    with pytest.raises(_build.BuildError, match="simulated"):
        fused.TemporalStep(params, obstacles, fcinv, torch.device("cuda", 0),
                           by=4, bx=4, ksteps=2, storage=storage)
    launches = dict(fused.LAUNCHES)
    monkeypatch.setattr(_build, "load_library", lambda: object())
    with pytest.raises(ValueError, match="CUDA or CPU"):
        prog.bind(f, torch.empty_like(f), av)
    assert fused.LAUNCHES == launches


def test_the_16bit_entry_is_declared():
    """The 16-bit entry takes the fp32 entry's arguments up to its
    persistent grid, then the flag of bfloat16 storage, then the stream;
    its occupancy entry the fp32 one's arguments, the flag in place of the
    shard's.  The source runs a persistent pass with the four conversions,
    and picks its copy width as ``_geom16`` mirrors: the fp32 rule
    (``lbm::pass_vec``) in 16-bit values."""
    assert "lbm_temporal16_step" in fused.LAUNCHES
    argtypes, _ = _build.SIGNATURES["lbm_temporal16_step"]
    fp32 = _build.SIGNATURES["lbm_temporal_step"][0]
    assert argtypes[:10] == fp32[:10]
    assert argtypes[10:] == [ctypes.c_int, ctypes.c_void_p] == [fp32[9], fp32[-1]]
    assert (_build.SIGNATURES["lbm_temporal16_blocks_per_sm"]
            == _build.SIGNATURES["lbm_temporal_blocks_per_sm"])
    src = (_build.SOURCES[0].parent / "lbm_temporal16.cu").read_text()
    for intrinsic in ("__half2float", "__bfloat162float", "__float2half_rn",
                      "__float2bfloat16_rn", "persistent16_pass<T, kPassThreads>",
                      "lbm::warp0_tree_sum<kThreads>", "lbm::launch_pass<kPassThreads>(",
                      "lbm::pass_blocks_per_sm<kPassThreads>(",
                      "const uintptr_t all = static_cast<uintptr_t>(nx | bx | ksteps) | "
                      "(fa >> 1);",
                      "g.vec = (fa & 1) ? -1 : (all & 7) == 0 ? 8 : (all & 3) == 0 ? 4 : "
                      "(all & 1) == 0 ? 2 : 1;",
                      "nx % 4 == 0 && bx % 4 == 0 && ksteps % 4 == 0"):
        assert intrinsic in re.sub(r"\s+", " ", src)
    # No span wider than the window: the stage is the window itself.
    for gone in ("sw", "stage_pad", "gcd"):
        assert not re.search(rf"\b{gone}\b", src)


def _geom16(ny, nx, by, bx, k, addr):
    """The C entry's copy geometry (``geom16``) for f_in at ``addr`` values
    past an aligned allocation: (16-bit values per f copy: the largest of
    8, 4, 2 dividing nx, BX, K and addr, else 1 for plain loads; mask bytes
    per copy)."""
    vec = next((v for v in (8, 4, 2) if not (nx | bx | k | addr) % v), 1)
    mvec = 4 if nx % 4 == 0 and bx % 4 == 0 and k % 4 == 0 else 1
    return vec, mvec


def _emulated_16bit_pass(prog, f, blocks, addr):
    """One pass of the 16-bit kernel in its walk order by ``blocks``
    blocks: each tile's window staged as the kernel copies it (each chunk
    of ``vec`` values from its first column, never wrapping inside), the
    mask likewise by chunks of ``mvec``, read widened (exact, so the first
    step's reads from the stage are the fp32 window's), K fp32 window
    steps, the centre rounded to the storage type.  Returns (f_out, av)."""
    ny, nx = prog.params.ny, prog.params.nx
    by, bx, k = prog.by, prog.bx, prog.chunk
    wy, wx = by + 2 * k, bx + 2 * k
    vec, mvec = _geom16(ny, nx, by, bx, k, addr)
    assert x_starts_on_chunks(nx, bx, k, vec)  # no window row starts inside a chunk
    tiles_x = nx // bx
    tiles = (ny // by) * tiles_x
    fluid = prog.fluid.bool()
    ctr = (..., slice(k, k + by), slice(k, k + bx))
    out = torch.empty_like(f)

    def chunked(x0, width, v):
        starts = (x0 + v * torch.arange(width // v)) % nx
        assert bool((starts + v <= nx).all())  # a chunk never straddles the wrap
        return (starts[:, None] + torch.arange(v)).reshape(-1)

    def stage(t):
        ty, tx = divmod(t, tiles_x)
        y0, x0 = ty * by - k, tx * bx - k
        rows = ((y0 + torch.arange(wy)) % ny)[:, None]
        staged = f[:, rows, chunked(x0, wx, vec)[None, :]]  # [9, wy, wx]
        return staged, fluid[rows, chunked(x0, wx, mvec)[None, :]]

    sums = torch.zeros(k, dtype=torch.float32)
    windows = {b: stage(b) for b in range(min(blocks, tiles))}
    for j in range(-(-tiles // blocks)):
        for b in range(blocks):
            t = b + j * blocks
            if t >= tiles:
                continue
            staged, m = windows[b]
            w = staged.to(torch.float32)  # as step 0 reads it
            ty, tx = divmod(t, tiles_x)
            kick = ((ty * by - k + torch.arange(wy)) % ny == ny - 2)[:, None]
            w, step_sums = fused.advance_windows(w, m, kick, k, ctr, prog.params)
            if t + blocks < tiles:
                windows[b] = stage(t + blocks)
            out[:, ty * by:(ty + 1) * by, tx * bx:(tx + 1) * bx] = w[ctr].to(prog.storage)
            sums += torch.stack(step_sums)
    return out, sums * prog._fcinv


def x_starts_on_chunks(nx, bx, k, vec):
    """Every window row's first column, tx*BX - K wrapped, is a multiple
    of vec."""
    return all((tx * bx - k) % nx % vec == 0 for tx in range(nx // bx))


# (ny, nx, by, bx, K, f_in's offset in values): 16-byte copies (K 8),
# 8-byte copies (the main tile's K 4), 4-byte copies (nx = 2 mod 4), plain
# loads (nx odd), plain loads (an odd offset), plain loads (K odd).
WALK16 = [(32, 64, 8, 16, 8, 0), (32, 64, 8, 16, 4, 0), (48, 90, 8, 18, 2, 0),
          (24, 45, 8, 15, 3, 0), (32, 64, 8, 16, 4, 1), (32, 64, 8, 16, 3, 0)]


@pytest.mark.parametrize("shape", WALK16,
                         ids=["16B", "8B", "4B", "plain-nx", "plain-addr", "plain-K"])
@pytest.mark.parametrize("storage", [s for s, _ in STORAGES], ids=IDS)
def test_persistent_16bit_walk_matches_plain_pass(shape, storage):
    """The emulated walk by three blocks, bitwise the plain pass in f."""
    ny, nx, by, bx, k, addr = shape
    params, obstacles, f0, fcinv = _setup(ny, nx, seed=ny + nx + addr)
    prog = fused.TemporalStep(params, obstacles, fcinv, CPU, by, bx, k, storage=storage)
    want = {(32, 64, 8, 0): 8, (32, 64, 4, 0): 4, (48, 90, 2, 0): 2, (24, 45, 3, 0): 1,
            (32, 64, 4, 1): 1, (32, 64, 3, 0): 1}[(ny, nx, k, addr)]
    assert _geom16(ny, nx, by, bx, k, addr)[0] == want
    f = torch.from_numpy(f0).to(storage)
    out, av = _emulated_16bit_pass(prog, f, 3, addr)
    ref, ref_av = prog.plain_launch(f)
    assert out.dtype == storage and torch.equal(out, ref)
    np.testing.assert_allclose(av.numpy(), ref_av.numpy(), rtol=1e-6)


def test_16bit_geometry_at_the_main_tile():
    """1024^2 at 32x64, K 4: 8-byte copies of the window's 72-value rows,
    each starting on a chunk, the mask by 4-byte copies; an f bound 2
    values off its allocation narrows them to 4 bytes, 1 value off to
    plain loads; K 8 widens them to 16 bytes."""
    assert _geom16(1024, 1024, 32, 64, 4, 0) == (4, 4)
    assert x_starts_on_chunks(1024, 64, 4, 4)
    assert _geom16(1024, 1024, 32, 64, 4, 2) == (2, 4)
    assert _geom16(1024, 1024, 32, 64, 4, 1) == (1, 4)
    assert _geom16(1024, 1024, 16, 32, 8, 0) == (8, 4)
    # K odd: the window rows start on odd columns, so plain loads.
    assert _geom16(1024, 1024, 32, 64, 3, 0) == (1, 1)
    assert not x_starts_on_chunks(1024, 64, 3, 2)


@pytest.mark.parametrize("storage, jax_storage", STORAGES, ids=IDS)
def test_persistent_16bit_walk_matches_pallas_kernel(storage, jax_storage):
    """The emulated walk against lbm_tpu's ``storage=`` kernel in
    interpret mode on the same input each pass (32x48, JAX's 8-row blocks,
    the port's 8x16 tiles, K 4): f within one 16-bit step, av rtol 1e-4."""
    params, obstacles, f0, fcinv = _setup(32, 48, seed=91)
    program = build_temporal_program(params, obstacles, fcinv, by=8, ksteps=4,
                                     interpret=True, storage=jax_storage)
    jstep = jax.jit(program.step)
    carry = program.init(jnp.asarray(f0))
    ours = fused.TemporalStep(params, obstacles, fcinv, CPU, by=8, bx=16, ksteps=4,
                              storage=storage)
    f = torch.from_numpy(f0).to(storage)
    for _ in range(3):
        out, av = _emulated_16bit_pass(ours, f, 3, 0)
        carry, jav = jstep(carry)
        np.testing.assert_allclose(av.numpy(), np.asarray(jav), rtol=AV_RTOL)
        theirs = torch.from_numpy(np.array(program.final(carry))).to(storage)
        assert _ulps(out, theirs) <= 1
        f = theirs


@pytest.mark.parametrize("storage", [s for s, _ in STORAGES], ids=IDS)
def test_16bit_program_sizes_its_grid_before_any_launch(storage, monkeypatch):
    """A 16-bit program made for a device other than the CPU (tensors on the
    meta device, the card stubbed) takes ``nblocks`` from the 16-bit
    kernel's own occupancy in its type, as the fp32 program does from its
    kernel's: min(tiles, SMs x blocks an SM)."""
    seen = []

    class Lib:
        def lbm_sm_count(self, device):
            return 132

        def lbm_temporal_blocks_per_sm(self, by, bx, k, shard):
            raise AssertionError("sized the 16-bit grid from the fp32 kernel")

        def lbm_temporal16_blocks_per_sm(self, by, bx, k, bf16):
            seen.append((by, bx, k, bf16))
            return 2

    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(_build, "load_library", Lib)
    params, obstacles, _, fcinv = _setup(512, 512, seed=98)
    launches = dict(fused.LAUNCHES)
    prog = fused.TemporalStep(params, obstacles, fcinv, torch.device("meta"), 16, 32, 4,
                              storage=storage)
    assert prog.nblocks == min(32 * 16, 132 * 2) == 264
    assert seen == [(16, 32, 4, int(storage == torch.bfloat16))]
    assert prog.partials.numel() == 4 * 32 * 16
    assert fused.LAUNCHES == launches


@pytest.mark.parametrize("storage, jax_storage", STORAGES, ids=IDS)
def test_drift_run_matches_lbm_tpu(storage, jax_storage):
    """``fp16_experiment``'s run at a small grid against a JAX ``storage=``
    run of the same row blocks and K (the port's tile is a 2-D tile of the
    same rows), every av value of six free-running passes, within one
    epsilon of the storage type: the two packages' fp32 passes differ in
    the last fp32 bits, so a few roundings land one 16-bit step apart and
    those steps carry on from pass to pass (2.3e-4 for float16 here)."""
    params = lbm_tpu.LBMParams(48, 32, 24, 10, 0.1, 0.005, 1.85)
    obstacles = channel_box(48, 32)
    fcinv = np.float32(1.0) / np.float32(free_cells_of(obstacles))
    ported = LBMParams(**dataclasses.asdict(params))
    ours = fp16_experiment.storage_av(ported, obstacles, storage, CPU, tile=(8, 16, 4))
    program = build_temporal_program(params, obstacles, fcinv, by=8, ksteps=4,
                                     interpret=True, storage=jax_storage)
    jstep = jax.jit(program.step)
    carry = program.init(jnp.asarray(jax_init_cells(params)))
    javs = []
    for _ in range(6):
        carry, jav = jstep(carry)
        javs.append(np.asarray(jav))
    np.testing.assert_allclose(ours, np.concatenate(javs), rtol=torch.finfo(storage).eps)
    # The tool's own tile at this grid and length is the chooser's.
    assert fp16_experiment.drift_tile(ported, CPU) == (16, 16, 4)


def test_fp16_experiment_arguments(monkeypatch):
    with pytest.raises(SystemExit):
        fp16_experiment.main(["drift", "--case", "64x64"])
    with pytest.raises(SystemExit):
        fp16_experiment.main(["drift", "--case", "128x128", "--storage", "float64"])
    with pytest.raises(SystemExit, match="NYxNX"):
        fp16_experiment.main(["time", "--grid", "1024"])
    with pytest.raises(SystemExit, match="all of --by, --bx and --k"):
        fp16_experiment.main(["time", "--grid", "64x64", "--by", "8"])
    with pytest.raises(SystemExit, match="--repeats"):
        fp16_experiment.main(["time", "--grid", "64x64", "--repeats", "0"])
    with pytest.raises(SystemExit, match="no 80001-step golden"):
        fp16_experiment.golden_av("256x256", 80001)
    assert fp16_experiment.golden_av("256x256", 80000).shape == (80000,)


def test_fp16_experiment_time_uses_the_timer(monkeypatch, capsys):
    """``time`` gives fp32, bf16 and fp16 at one tile through the
    autotuner's timer (stubbed: it times on the card)."""
    calls = []

    def fake_time(params, obstacles, by, bx, k, steps, repeats, log=print,
                  schedule="temporal", storage=None):
        calls.append((by, bx, k, steps, storage))
        return {torch.float32: 20.0, torch.bfloat16: 16.0, torch.float16: 10.0}[storage]

    monkeypatch.setattr(tuning, "time_temporal_candidate", fake_time)
    assert fp16_experiment.main(["time", "--grid", "1024x1024"]) == 0
    assert calls == [(32, 64, 4, 4800, s) for s in fp16_experiment.STORAGES.values()]
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    rows = [json.loads(ln) for ln in lines]
    assert [r.get("storage") for r in rows[:3]] == ["float32", "bfloat16", "float16"]
    assert rows[3]["speedup_bfloat16_vs_fp32"] == 1.25
    assert rows[4]["speedup_float16_vs_fp32"] == 2.0
    assert all(r["glups"] == 1024 * 1024 / r["us_per_step"] / 1e3 for r in rows[:3])
    # An explicit tile; the steps cut to a multiple of K.
    calls.clear()
    assert fp16_experiment.main(["time", "--grid", "64x64", "--by", "16", "--bx", "32",
                                 "--k", "8", "--steps", "100", "--repeats", "1"]) == 0
    assert calls == [(16, 32, 8, 96, s) for s in fp16_experiment.STORAGES.values()]

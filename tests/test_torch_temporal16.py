"""The temporal program with f stored in 16 bits (``TemporalStep(storage=
torch.float16 / torch.bfloat16)``) against lbm_tpu's
``_step_kernel_temporal`` with ``storage=`` (``build_temporal_program(...,
storage=..., interpret=True)``, as ``tests/test_fused.py`` runs it), the
plain version's definition, the buffers' dtype, the refusals, and its
refusal to fall back.

On the CPU the program runs its plain version: f widened to fp32, the
fp32 window pass, the new f rounded to nearest even.  The CUDA kernel
(``csrc/lbm_temporal16.cu``) is held against that plain version on the
card by ``chip_smoke.py``.  Tolerances of one pass against lbm_tpu's on
the same input: f within one ulp of the storage type (the two packages'
fp32 passes may differ in the last fp32 bits, which can move a rounding
by one 16-bit step), av rtol 1e-4 (av comes from the fp32 window, summed
in another order).
"""

import ctypes
import dataclasses
import json

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
from lbm_tpu_torch.ops import _build, fused
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
    """The 16-bit entry takes the fp32 entry's arguments up to K, then the
    flag of bfloat16 storage where the fp32 entry takes its persistent
    grid, then the stream."""
    assert "lbm_temporal16_step" in fused.LAUNCHES
    argtypes, _ = _build.SIGNATURES["lbm_temporal16_step"]
    fp32 = _build.SIGNATURES["lbm_temporal_step"][0]
    assert argtypes[:9] == fp32[:9]
    assert argtypes[9:] == [ctypes.c_int, ctypes.c_void_p] == [fp32[9], fp32[-1]]
    src = (_build.SOURCES[0].parent / "lbm_temporal16.cu").read_text()
    for intrinsic in ("__half2float", "__bfloat162float", "__float2half_rn",
                      "__float2bfloat16_rn", "lbm::advance_window<kThreads>",
                      "lbm::window_smem_bytes(by, bx, ksteps)"):
        assert intrinsic in src


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

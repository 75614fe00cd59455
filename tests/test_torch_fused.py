"""The fused one-step program against lbm_tpu's Pallas kernels, and the
CUDA wrapper's refusal to fall back.

The JAX side runs ``build_fused_program(..., interpret=True)`` as
``tests/test_fused.py`` does: ``by == ny`` is ``_step_kernel_single`` and
``by = 8`` with P >= 3 blocks is ``_step_kernel_blocked``.  On the CPU
``FusedStep`` runs its plain torch version; the CUDA kernel itself is held
against that plain version on the card by ``chip_smoke.py``.  Tolerances
as in test_torch_reference.py: f atol 1e-6, av rtol 1e-4.
"""

import ctypes
import pathlib
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops.fused import build_fused_program
from lbm_tpu_torch.geometry import free_cells_of
from lbm_tpu_torch.ops import _build, fused
from lbm_tpu_torch.testing import gate_case

F_ATOL, AV_RTOL = 1e-6, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The grids here are small, and the suite runs in parallel workers:
    intra-op threads only contend (measured 3x slower at 128x128)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(ny, nx, seed):
    params, obstacles, f0 = gate_case(ny, nx, seed)
    fcinv = np.float32(1.0) / np.float32(free_cells_of(obstacles))
    return params, obstacles, f0, fcinv


@pytest.mark.parametrize(
    "ny, nx, by",
    [(24, 40, 24), (32, 48, 8)],
    ids=["single-by-eq-ny", "blocked-by8-P4"],
)
def test_plain_fused_step_matches_pallas_kernel(ny, nx, by):
    params, obstacles, f0, fcinv = _setup(ny, nx, seed=by)
    program = build_fused_program(params, obstacles, fcinv, by, interpret=True)
    jstep = jax.jit(program.step)
    carry = program.init(jnp.asarray(f0))
    step = fused.FusedStep(params, obstacles, fcinv, torch.device("cpu"))
    a, b = torch.from_numpy(f0.copy()), torch.empty(f0.shape, dtype=torch.float32)
    av = torch.empty(20, dtype=torch.float32)
    launches = dict(fused.LAUNCHES)
    for t in range(20):
        carry, jav = jstep(carry)
        step(a, b, av, t)
        a, b = b, a
        np.testing.assert_allclose(float(av[t]), float(jav), rtol=AV_RTOL)
    np.testing.assert_allclose(
        a.numpy(), np.asarray(program.final(carry)), rtol=0, atol=F_ATOL
    )
    assert fused.LAUNCHES == launches  # the CPU path launches nothing


def test_single_and_reference_step_agree():
    params, obstacles, f0, fcinv = _setup(16, 24, seed=3)
    f = torch.from_numpy(f0)
    fused_out, fused_av = fused.FusedStep(params, obstacles, fcinv, "cpu").single(f)
    ref_out, ref_av = fused.ReferenceStep(params, obstacles, fcinv, "cpu").single(f)
    np.testing.assert_array_equal(fused_out.numpy(), ref_out.numpy())
    assert float(fused_av) == float(ref_av)


def test_step_params_are_lbm_tpu_fp32_values():
    params, obstacles, _, fcinv = _setup(16, 24, seed=4)
    p = fused.step_params(params, fcinv)
    aw1, aw2 = (np.float32(v) for v in (p.aw1, p.aw2))
    da = np.float32(params.density) * np.float32(params.accel)
    assert (aw1, aw2) == (da / np.float32(9.0), da / np.float32(36.0))
    assert np.float32(p.omega) == np.float32(params.omega)
    assert np.float32(p.free_cells_inv) == fcinv
    assert list(p.kick) == [0.0, aw1, 0.0, -aw1, 0.0, aw2, -aw2, -aw2, aw2]
    assert (p.ny, p.nx) == (16, 24)


def test_kernel_struct_layout_matches_source():
    """The C struct the kernels read, field for field and type for type."""
    src = _build.HEADERS[0].read_text()
    body = re.search(r"struct StepParams \{(.*?)\};", src, re.S).group(1)
    c_fields = re.findall(r"(int|float)\s+(\w+)(\[9\])?;", body)
    py_fields = [
        (("int" if t is ctypes.c_int else "float"), n, "" if t in (ctypes.c_int, ctypes.c_float) else "[9]")
        for n, t in fused._StepParams._fields_
    ]
    assert c_fields == py_fields


def test_kernel_source_and_flags():
    for path in _build.SOURCES + _build.HEADERS:
        src = path.read_text()
        assert not re.search(r"\batomic\w*\s*\(", src), path  # fixed-order av sums
        # The shared update, directly or through the window header, in
        # every source but the issue-rate probe and the exchange's
        # transport, which update no cell.
        assert (any(f'#include "{h.name}"' in src for h in _build.HEADERS)
                or path in _build.HEADERS
                or path.name in ("lbm_roofline.cu", "lbm_ipc.cu"))
    assert '#include "lbm_cell.cuh"' in _build.HEADERS[1].read_text()
    assert {p.name for p in _build.SOURCES} == {
        p.name for p in _build.SOURCES[0].parent.glob("*.cu")
    }
    flags = " ".join(_build.NVCC_FLAGS + _build.LINK_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "-fmad=false" in flags
    assert "-shared" in flags and "-fPIC" in flags


def test_library_path_tracks_the_source(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// a\n")
    monkeypatch.setattr(_build, "SOURCES", (src,))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.library_path()
    assert first.parent == tmp_path / "build"
    assert _build.library_path() == first
    src.write_text("// b\n")
    assert _build.library_path() != first


def _no_plain(*args, **kwargs):
    raise AssertionError("the CUDA path fell back to the plain version")


@pytest.fixture()
def fresh_library_cache():
    _build.load_library.cache_clear()
    yield
    _build.load_library.cache_clear()


def test_missing_nvcc_raises(tmp_path, monkeypatch, fresh_library_cache):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    params, obstacles, _, fcinv = _setup(8, 12, seed=5)
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        fused.FusedStep(params, obstacles, fcinv, torch.device("meta"))


def test_failing_compile_raises_with_the_log(tmp_path, monkeypatch, fresh_library_cache):
    false = shutil.which("false")
    if false is None:
        pytest.fail("no `false` binary to stand in for a failing nvcc")
    monkeypatch.setattr(_build, "find_nvcc", lambda: false)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(_build.BuildError, match="nvcc failed"):
        _build.load_library()
    assert not any(p.suffix in (".so", ".tmp") for p in pathlib.Path(tmp_path).iterdir())


def test_non_cpu_tensors_never_take_the_plain_path(monkeypatch):
    """A failed build raises out of the step itself, and a device the
    kernel cannot take raises too: neither returns the plain result."""
    params, obstacles, f0, fcinv = _setup(8, 12, seed=6)
    step = fused.FusedStep(params, obstacles, fcinv, "cpu")
    monkeypatch.setattr(step, "_plain_into", _no_plain)
    monkeypatch.setattr(step, "plain", _no_plain)
    f = torch.empty(f0.shape, device="meta")
    av = torch.empty(1, device="meta")

    def failing_build():
        raise _build.BuildError("simulated build failure")

    monkeypatch.setattr(_build, "load_library", failing_build)
    with pytest.raises(_build.BuildError, match="simulated"):
        step(f, torch.empty_like(f), av, 0)

    with pytest.raises(_build.BuildError, match="simulated"):
        step.bind(f, torch.empty_like(f), av)

    launches = dict(fused.LAUNCHES)
    monkeypatch.setattr(_build, "load_library", lambda: object())
    with pytest.raises(ValueError, match="CUDA or CPU"):
        step(f, torch.empty_like(f), av, 0)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        step.bind(f, torch.empty_like(f), av)
    assert fused.LAUNCHES == launches


def test_cuda_program_builds_before_anything_else(monkeypatch):
    """Constructing the program for a non-CPU device builds first, so a
    failed build surfaces before any allocation or timer."""
    params, obstacles, _, fcinv = _setup(8, 12, seed=7)

    def failing_build():
        raise _build.BuildError("simulated build failure")

    monkeypatch.setattr(_build, "load_library", failing_build)
    with pytest.raises(_build.BuildError):
        fused.FusedStep(params, obstacles, fcinv, torch.device("cuda", 0))
    with pytest.raises(ValueError, match="obstacle mask"):
        fused.ReferenceStep(params, obstacles[:-1], fcinv, "cpu")

"""lbm_tpu_torch stands alone: it imports no JAX, no lbm_tpu and no tools/.

The machine with the CUDA card has no JAX, and ``lbm_tpu`` pulls JAX in
through its package ``__init__``, so the port and ``chip_smoke.py`` must
not reach either, not even lazily inside a function.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from lbm_tpu.ops import lattice as jax_lattice
from lbm_tpu_torch.ops import lattice

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN_ROOTS = {"jax", "jaxlib", "lbm_tpu", "tools"}
MODULES = [
    "lbm_tpu_torch",
    "lbm_tpu_torch.cli",
    "lbm_tpu_torch.checker",
    "lbm_tpu_torch.convert",
    "lbm_tpu_torch.testing",
    "lbm_tpu_torch.ops.fused",
    "lbm_tpu_torch.parallel.sharded",
    "lbm_tpu_torch.parallel.dist",
    "lbm_tpu_torch.tools.multihost_smoke",
    "lbm_tpu_torch.tools.plot_final_state",
    "lbm_tpu_torch.tools.bench_sharded",
    "lbm_tpu_torch.tools.ablate_step",
    "lbm_tpu_torch.tools.roofline",
    "lbm_tpu_torch.tools.autotune",
    "lbm_tpu_torch.tools.fp16_experiment",
    "lbm_tpu_torch.tools.gen_goldens",
    "lbm_tpu_torch.tools.gen_inputs",
    "lbm_tpu_torch.tools.check_self",
    "lbm_tpu_torch.tools.bench_all",
    "lbm_tpu_torch.tuning",
    "lbm_tpu_torch.validation",
    "lbm_tpu_torch._native",
    "lbm_tpu_torch.utils.debugging",
    "lbm_tpu_torch.utils.profiling",
    "chip_smoke",
]


def test_import_loads_no_jax_in_a_fresh_interpreter():
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in MODULES)
        + f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN_ROOTS!r})\n"
        + "print(bad)\n"
        + "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_import_needs_no_compiler():
    """Importing every module finds no nvcc and no C compiler on an empty
    PATH, and builds nothing: the native I/O and the kernels build on first
    use."""
    code = (
        "".join(f"import {m}\n" for m in MODULES)
        + "from lbm_tpu_torch import _native\n"
        + "from lbm_tpu_torch.ops import _build\n"
        + "assert _native.library.cache_info().currsize == 0\n"
        + "assert _build.load_library.cache_info().currsize == 0\n"
        + "assert _native.find_compiler() is None\n"
    )
    env = {"PATH": "", "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_all_covers_lbm_tpu():
    """The port exports lbm_tpu's public names, but enable_compile_cache
    (JAX's persistent compile cache; the port keeps its built kernel
    library by a hash of its sources and needs no switch)."""
    import lbm_tpu
    import lbm_tpu_torch

    assert set(lbm_tpu.__all__) - set(lbm_tpu_torch.__all__) == {"enable_compile_cache"}
    for name in lbm_tpu_torch.__all__:
        assert hasattr(lbm_tpu_torch, name), name


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path",
    sorted((ROOT / "lbm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_import_statement_reaches_jax(path):
    """Also catches imports inside functions, which the fresh-interpreter
    test does not execute."""
    assert not _imported_roots(path) & FORBIDDEN_ROOTS


def test_lattice_sanity_and_parity():
    lattice.sanity()
    for name in ("CX", "CY", "OPPOSITE", "WEIGHTS"):
        np.testing.assert_array_equal(
            getattr(lattice, name), getattr(jax_lattice, name)
        )
        assert getattr(lattice, name).dtype == getattr(jax_lattice, name).dtype
    assert lattice.KICK_SIGNS == jax_lattice.KICK_SIGNS
    for k in range(lattice.NSPEEDS):
        assert lattice.kick_scale(k, 2.0, 3.0) == jax_lattice.kick_scale(k, 2.0, 3.0)

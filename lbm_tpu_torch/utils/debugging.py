"""Numerical debugging aids (the port of ``lbm_tpu.utils.debugging``).

* :func:`nan_guard` — an opt-in scope that checks, after each program
  launch of a run inside it, that f and av are finite, and raises on the
  first launch that made a non-finite value (the FP-trap analog; the
  counterpart of ``jax_debug_nans``).
* :func:`interpret_kernels` — a scope in which every program runs its plain
  torch version in place of its CUDA kernel, on whatever device f is on
  (the counterpart of Pallas interpret mode).
* :func:`assert_mass_conserved` — the ``total_density`` invariant as an
  assertion for tests and long-run monitoring.

Both scopes hold for the code that runs inside them in this thread (or
asyncio task), and only there; each is asked for by name, never entered
by itself.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterable

import numpy as np
import torch

from lbm_tpu_torch.diagnostics import total_density

_NAN_GUARD = contextvars.ContextVar("lbm_tpu_torch_nan_guard", default=False)
_INTERPRET = contextvars.ContextVar("lbm_tpu_torch_interpret_kernels", default=False)


@contextlib.contextmanager
def _scope(var: contextvars.ContextVar):
    token = var.set(True)
    try:
        yield
    finally:
        var.reset(token)


def nan_guard():
    """Raise ``FloatingPointError`` on the first launch inside the scope
    that leaves a non-finite value in f or av (each launch then waits for
    the device)."""
    return _scope(_NAN_GUARD)


def interpret_kernels():
    """Run every program's plain version in place of its CUDA kernel."""
    return _scope(_INTERPRET)


def guarding() -> bool:
    """Whether the caller is inside :func:`nan_guard`."""
    return _NAN_GUARD.get()


def interpreting() -> bool:
    """Whether the caller is inside :func:`interpret_kernels`."""
    return _INTERPRET.get()


def guarded(
    launch: Callable[[int], None],
    written: Callable[[int], Iterable[tuple[str, torch.Tensor]]],
) -> Callable[[int], None]:
    """``launch`` itself, or, inside :func:`nan_guard`, ``launch`` followed
    by a check that every ``(name, tensor)`` of ``written(i)`` (what launch
    ``i`` wrote) is finite."""
    if not _NAN_GUARD.get():
        return launch

    def checked(i: int) -> None:
        launch(i)
        for name, x in written(i):
            if not bool(torch.isfinite(x).all()):
                raise FloatingPointError(
                    f"nan_guard: launch {i} left a non-finite value in {name}")

    return checked


def assert_mass_conserved(
    f_before: np.ndarray, f_after: np.ndarray, rtol: float = 1e-5
) -> None:
    """Total density must be invariant across steps (the body force's kick
    adds and removes equal mass, so it holds there too)."""
    m0 = total_density(f_before)
    m1 = total_density(f_after)
    if not np.isfinite(m1) or abs(m1 - m0) > rtol * abs(m0):
        raise AssertionError(
            f"mass not conserved: {m0!r} -> {m1!r} (rtol {rtol})"
        )

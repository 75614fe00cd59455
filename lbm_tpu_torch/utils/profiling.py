"""Profiling and performance accounting.

* :func:`span` — the program's spans, one at each layer boundary (the run,
  the graph capture and replay, the CLI and its writers, the process's own
  set-up), recorded only while a ``torch.profiler`` records: each also opens
  ``torch.profiler.record_function`` with its name, so every profile holds
  the program's spans on the device's clock.  :func:`spans` and
  :func:`take_spans` read them; a span that holds two CUDA events
  (``events``) reads the device's time between them (``device_ms``).
* :func:`trace` — context manager around ``torch.profiler`` that writes a
  Chrome trace (``trace.json``) of what ran inside it, spans included.
* :class:`PerfReport` — MLUPS and effective device-memory bandwidth of a
  run.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import itertools
import pathlib
import time

import torch

# Device-memory bytes per cell update of the one-step kernel: read 9 fp32
# populations and the uint8 fluid mask, write 9 fp32 populations.
# (lbm_tpu's BYTES_PER_CELL counts 76: its mask is fp32.)  A program that
# advances several steps per pass moves fewer per update: each step
# program states its own (``bytes_per_update`` in ops/fused.py), as
# lbm_tpu divides by ``steps_per_pass``.
BYTES_PER_CELL = 9 * 4 + 1 + 9 * 4

# Whether a torch.profiler records (~0.1 us; record_function costs ~10 us
# even with none recording).
recording = torch._C._autograd._profiler_enabled
# The newest spans kept: a process that records on and on (a scheduled
# profiler) keeps no more; a reader takes them (take_spans) as it goes.
MAX_SPANS = 1 << 16


@dataclasses.dataclass
class Span:
    """One recorded span: host times from ``time.perf_counter`` (``end`` is
    None while it is open), its id, the id of the span open around it and
    that of its root (shared by every span of one run or one CLI call), and
    the counts taken at its boundary (``attrs``; :meth:`set` adds more).
    ``events``, two CUDA events recorded around the span's device work,
    give :attr:`device_ms`."""

    name: str
    id: int
    parent: int | None
    root: int
    start: float
    end: float | None = None
    attrs: dict = dataclasses.field(default_factory=dict)
    always: bool = False  # a set-up stage, recorded with no profiler too
    events: tuple | None = None

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def device_ms(self) -> float | None:
        """The device's milliseconds between ``events`` (waits for the
        second: read after the run's own synchronisation, it waits for
        nothing); None without events."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


class _Off:
    """What :func:`span` gives where nothing records: a context whose handle
    takes counts and drops them, and is false."""

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> None:
        pass

    def __bool__(self) -> bool:
        return False


OFF = _Off()
_OPEN: contextvars.ContextVar[tuple[Span, ...]] = contextvars.ContextVar(
    "lbm_tpu_torch_open_spans", default=())
_SPANS: collections.deque[Span] = collections.deque(maxlen=MAX_SPANS)
_IDS = itertools.count(1)


class _Recording:
    __slots__ = ("name", "attrs", "always", "span", "token", "range")

    def __init__(self, name: str, always: bool, attrs: dict) -> None:
        self.name, self.always, self.attrs = name, always, attrs

    def __enter__(self) -> Span:
        open_ = _OPEN.get()
        sid = next(_IDS)
        parent = open_[-1] if open_ else None
        self.range = None
        if recording():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.span = Span(self.name, sid, parent.id if parent else None,
                         parent.root if parent else sid, time.perf_counter(),
                         attrs=self.attrs, always=self.always)
        self.token = _OPEN.set(open_ + (self.span,))
        return self.span

    def __exit__(self, *exc) -> None:
        self.span.end = time.perf_counter()
        _OPEN.reset(self.token)
        if self.range is not None:
            self.range.__exit__(*exc)
        _SPANS.append(self.span)


def span(name: str, *, always: bool = False, **attrs):
    """``with span("io.av_vels") as s: ...; s.set(bytes=n)``.

    Records a :class:`Span` only while a ``torch.profiler`` records, and
    then also opens ``record_function(name)``; else returns :data:`OFF`,
    which records nothing and enters no ``record_function``.  ``always``
    records a stage that runs once a process (set-up, before any profiler
    starts) in either case."""
    if always or recording():
        return _Recording(name, always, attrs)
    return OFF


def spans() -> list[Span]:
    """The spans recorded in this process and not yet taken (the newest
    :data:`MAX_SPANS`), in the order they closed."""
    return list(_SPANS)


def take_spans() -> list[Span]:
    """:func:`spans`, and forget them."""
    out = []
    while _SPANS:
        out.append(_SPANS.popleft())
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("prof"): sim.run()`` -> ``prof/trace.json``, with CUDA
    activity when a CUDA device is present; the program's spans inside are
    ranges of the trace, and are taken (:func:`take_spans`) when it ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    take_spans()
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))


@dataclasses.dataclass(frozen=True)
class PerfReport:
    """Derived performance figures for one run."""

    nx: int
    ny: int
    steps: int
    elapsed: float
    bytes_per_update: float = float(BYTES_PER_CELL)

    @property
    def cell_updates(self) -> int:
        return self.nx * self.ny * self.steps

    def _rate(self, quantity: float) -> float:
        # A zero-step run or a sub-timer-resolution elapsed reads as inf,
        # like diagnostics.ResultMetrics.mlups.
        if self.elapsed > 0.0:
            return quantity / self.elapsed
        return float("inf")

    @property
    def mlups(self) -> float:
        return self._rate(self.cell_updates) / 1e6

    @property
    def effective_bandwidth_gbs(self) -> float:
        """Nominal device-memory GB/s at ``bytes_per_update`` per update."""
        return self._rate(self.cell_updates * self.bytes_per_update) / 1e9

"""Spans around the program's calls, and the device's record from the profiler.

In a traced run (``--trace 1``) :class:`Spans` wraps the calls that the
cell's traffic names (``traffic["spans"]``: ``"module:attribute"`` of the
program, e.g. ``"lbm_tpu_torch.runtime:Simulator.run"``) as the program
makes them: each call keeps its host times and opens a
``torch.profiler.record_function`` range, so that the profiler's timeline
holds the spans beside the device's operations.  Nothing is wrapped in an
untraced run.

:func:`read_profile` turns the profiler's events into :class:`DeviceTrace`:
the device operations, the spans on the same clock, and whether the
profile is whole: a record of every kernel launch that the program's
launch counters (``lbm_tpu_torch.ops.fused.LAUNCHES``) counted in the
window, by ``launches/<counter>.json``.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import functools
import importlib
import re
import time

import torch

PREFIX = "bench:"
SPIN_CYCLES = 200_000  # torch.cuda._sleep before and after a window: ~0.1 ms


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start: float  # seconds, host clock (time.perf_counter) or profiler clock
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Spans:
    """Host spans of a traced run, in the order they opened."""

    def __init__(self) -> None:
        self.items: list[Span] = []
        self._undo: list[tuple[object, str, object]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        start = time.perf_counter()
        try:
            with torch.profiler.record_function(PREFIX + name):
                yield
        finally:
            self.items.append(Span(name, start, time.perf_counter()))

    def wrap(self, target: str) -> None:
        """Wrap ``"package.module:Attr.path"`` in a span named
        ``module.Attr.path``."""
        module_name, _, path = target.partition(":")
        label = f"{module_name.rsplit('.', 1)[-1]}.{path}"
        owner = importlib.import_module(module_name)
        *parents, attr = path.split(".")
        for part in parents:
            owner = getattr(owner, part)
        inner = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
        spans = self

        @functools.wraps(inner)
        def wrapper(*args, **kwargs):
            with spans.span(label):
                return inner(*args, **kwargs)

        self._undo.append((owner, attr, inner))
        setattr(owner, attr, wrapper)

    def restore(self) -> None:
        while self._undo:
            owner, attr, inner = self._undo.pop()
            setattr(owner, attr, inner)


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str    # the kernel's short name, or "Memcpy DtoH" and the like
    kind: str    # "kernel", "memcpy" or "memset"
    start: float  # seconds, profiler clock
    end: float


@dataclasses.dataclass
class DeviceTrace:
    ops: list[DeviceOp]
    spans: list[Span]       # the benchmark's spans, profiler clock
    window: Span            # the measured window, profiler clock
    whole: bool
    why_not_whole: str

    def busy(self, ops: list[DeviceOp] | None = None) -> float:
        """Seconds of the window in which at least one device operation ran
        (the union of their intervals, so that operations side by side
        count once)."""
        busy, reach = 0.0, None
        w0, w1 = self.window.start, self.window.end
        for op in sorted(self.ops if ops is None else ops, key=lambda o: o.start):
            start, end = max(op.start, w0), min(op.end, w1)
            if end <= start:
                continue
            if reach is None or start >= reach:
                busy += end - start
                reach = end
            elif end > reach:
                busy += end - reach
                reach = end
        return busy

    def gaps(self) -> list[tuple[float, float]]:
        """The window's idle intervals: no device operation running."""
        out, reach = [], self.window.start
        for op in sorted(self.ops, key=lambda o: o.start):
            if op.start > reach:
                out.append((reach, min(op.start, self.window.end)))
            reach = max(reach, op.end)
            if reach >= self.window.end:
                break
        if reach < self.window.end:
            out.append((reach, self.window.end))
        return [(a, b) for a, b in out if b > a]

    def innermost(self) -> list[tuple[float, float, str]]:
        """The window cut into pieces, each named by the innermost benchmark
        span open over it ("harness" where none is): the spans nest, as the
        calls they wrap do."""
        edges = sorted([(s.start, 1, -s.end, s.name) for s in self.spans]
                       + [(s.end, 0, 0.0, s.name) for s in self.spans])
        pieces, stack, last = [], [], self.window.start
        for t, opens, _, name in edges:
            if t > last:
                pieces.append((last, t, stack[-1] if stack else "harness"))
                last = t
            if opens:
                stack.append(name)
            elif name in stack:
                del stack[len(stack) - 1 - stack[::-1].index(name)]
        pieces.append((last, self.window.end, stack[-1] if stack else "harness"))
        return [(a, b, n) for a, b, n in pieces if b > a]

    def idle_by_span(self) -> collections.Counter:
        """Idle seconds of the window by the span open while the device
        waited: each gap split over the spans it crosses."""
        idle, pieces, j = collections.Counter(), self.innermost(), 0
        for a, b in self.gaps():
            while j < len(pieces) and pieces[j][1] <= a:
                j += 1
            k = j
            while k < len(pieces) and pieces[k][0] < b:
                lo, hi, name = pieces[k]
                idle[name] += min(b, hi) - max(a, lo)
                k += 1
        return idle

    def in_spans(self, name: str, kind: str = "kernel") -> list[DeviceOp]:
        """The device operations of ``kind`` that started inside a span
        named ``name``."""
        spans = sorted((s for s in self.spans if s.name == name), key=lambda s: s.start)
        starts = [s.start for s in spans]
        out = []
        for op in self.ops:
            if op.kind != kind:
                continue
            i = bisect.bisect_right(starts, op.start) - 1
            if i >= 0 and op.start < spans[i].end:
                out.append(op)
        return out


def short_name(name: str) -> str:
    """``void at::native::foo_kernel<4, ...>(...)`` -> ``foo_kernel``."""
    n = name.replace("(anonymous namespace)::", "")
    n = n[5:] if n.startswith("void ") else n
    n = re.split(r"[(<]", n, maxsplit=1)[0].strip()
    return n.rsplit("::", 1)[-1] or name


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def expected_kernels(launches_delta: dict[str, int], launch_map: dict[str, dict]
                     ) -> tuple[collections.Counter, list[str]]:
    """The kernels that the counted launches stand for, and the counters
    that ``launches/`` has no file for."""
    want, unknown = collections.Counter(), []
    for counter, n in launches_delta.items():
        if n <= 0:
            continue
        if counter not in launch_map:
            unknown.append(counter)
            continue
        want[launch_map[counter]["kernel"]] += n
        for then in launch_map[counter].get("then", []):
            want[then] += n
    return want, unknown


def read_profile(prof, launches_delta: dict[str, int], launch_map: dict[str, dict]
                 ) -> DeviceTrace | None:
    """The device's record of a profiled window (None where the profiler
    recorded no window span)."""
    ops, spans, window = [], [], None
    events = prof.profiler.kineto_results.events()
    # Seconds from the first event: the profiler's clock is in ns since the
    # epoch, which a float of seconds would round to 0.4 us.
    base = min((e.start_ns() for e in events), default=0)
    for e in events:
        name = e.name()
        start = (e.start_ns() - base) * 1e-9
        end = (e.start_ns() - base + e.duration_ns()) * 1e-9
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation() or name.startswith(PREFIX) or end <= start:
                continue
            short = short_name(name)
            if short == "spin_kernel":
                continue
            ops.append(DeviceOp(short if _kind(name) == "kernel" else name.split(" (")[0],
                                _kind(name), start, end))
        elif name.startswith(PREFIX):
            span = Span(name[len(PREFIX):], start, end)
            if span.name == "window":
                window = span
            else:
                spans.append(span)
    if window is None:
        return None
    want, unknown = expected_kernels(launches_delta, launch_map)
    got = collections.Counter(op.name for op in ops if op.kind == "kernel" and op.name in want)
    if unknown:
        why = f"no launches/<counter>.json for {', '.join(sorted(unknown))}"
    elif not want:
        why = "the launch counters counted no kernel in the window"
    elif got != want:
        missing = {k: want[k] - got[k] for k in want if got[k] != want[k]}
        why = f"the profile lacks records: launched minus recorded {missing}"
    else:
        why = ""
    return DeviceTrace(ops, spans, window, not why, why)


def spin(device: torch.device) -> None:
    """A spin kernel, left out of every count: without one on either side
    of a profiled window the profiler has lost a first or last kernel."""
    if device.type == "cuda":
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize(device)

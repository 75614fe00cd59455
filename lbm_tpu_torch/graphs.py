"""The whole run as one device program: a run's launches replayed from
CUDA graphs.

``lbm_tpu`` compiles the entire time loop into one XLA program: ``lax.scan``
over the steps (``lbm_tpu/runtime.py:10-15, 426-472``), inside one
``shard_map`` for a mesh, with the halo ``ppermute`` compiled into the loop
body (``lbm_tpu/parallel/sharded.py:10-14, 85-96, 215-255``): the host
touches the data twice.  The port launches its kernels from Python, each
through a bound ``launch(i)`` (``ops/fused.py``'s program contract), and a
launch costs the host several microseconds.  :class:`GraphRunner` is the
port's counterpart of that scan: it captures a **period** of ``P``
launches of a bound program into one ``torch.cuda.CUDAGraph`` (and the
remainder of the run, ``launches % P``, into a second, shorter one),
outside any timer, and a run replays the period ``launches // P`` times,
then the remainder.

* ``P`` is even, so that the ping-pong parity of the buffers and of the
  exchanges (``exchanges[i % 2]``) is the same at every period's start:
  replay ``r`` runs launches ``r*P .. r*P + P-1`` with the arguments that
  launches ``0 .. P-1`` baked in.
* Every ``bind`` bakes its av (or sums) slot ``4 * chunk * i`` into the
  node, so the graph writes a scratch vector of ``P * chunk`` per output,
  and after each replay the scratch moves to its slice of the run's vector
  (one copy an output, on the same stream).  A commit kernel that reads a
  device counter would save those copies, but they are one a replay of
  ``P`` launches, and a copy keeps the run's vector where the eager loop
  puts it with no new kernel.
* A bound launch may carry a ``prologue``: callables the runner records at
  the start of each graph, before its first launch.  The bands multi-step
  kernel's handoff slots are zeroed there (a replay bakes in the epochs of
  its capture, so the last replay's tags would otherwise be the ones the
  next one waits for), and an in-place program's bands of parity 0 are
  filled from f (the state a run, a segment or a replay starts from), so
  each graph starts as a fresh run does.
* Launch counts: a capture counts its launches once (the wrappers count
  as they launch into the capture), and each replay adds that count to
  each of :data:`lbm_tpu_torch.ops.fused.COUNTS` (``LAUNCHES`` and
  ``ONE_CHUNK_LAUNCHES``), so the counts stay the device's launches; the
  capture's own count is taken back.

While a profiler records, each capture is a span ``graphs.capture`` and
a run's replays one span ``graphs.replay``, which on a CUDA device holds
two CUDA events around them (its ``device_ms``).

The capture is a parameter: :class:`CudaGraph` on a CUDA device, and on
the CPU a :class:`Recorder`, which records each ``launch(i)`` (and the
prologue) as a call and replays the recording, so the period, parity,
scratch and remainder bookkeeping is the same code on either.  A capture
or an instantiation that fails raises; nothing falls back to the eager
loop.

The route is chosen by topology (:func:`choose_route`), as
``sharded.choose_transport`` chooses the transport: ``"graph"`` where one
process drives every launch on one device, ``"eager"`` (a launch from
Python each, as before) over several processes (the device transport's
host waits on ``/dev/shm`` counters cannot be captured), over several
devices (a graph across cards is not checked on one card), under
``debugging.nan_guard`` (which checks after every launch), and for the
plain torch versions on a CUDA device (``kernel="reference"``,
``interpret_kernels``: they allocate their temporaries and synchronise).
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from lbm_tpu_torch.ops.fused import COUNTS
from lbm_tpu_torch.utils import debugging, profiling

ROUTES = ("graph", "eager")
# Launches a period graph holds: even, and long enough that a replay's host
# work (the replay and the scratch copies) is hidden behind its device time.
PERIOD = 128


def choose_route(devices, processes: int = 1, plain: bool = False) -> str:
    """``"graph"`` where one process runs every launch on one device and no
    ``nan_guard`` is active, except for plain torch versions on a CUDA
    device (``plain``, or inside ``interpret_kernels``); else
    ``"eager"``."""
    devs = set(devices)
    if processes != 1 or len(devs) != 1 or debugging.guarding():
        return "eager"
    (dev,) = devs
    if dev.type == "cuda" and (plain or debugging.interpreting()):
        return "eager"
    return "graph"


def check_route(route: str) -> str:
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    return route


class Recorder:
    """The CPU's stand-in for a CUDA graph: :meth:`record` keeps each call
    (``plan``: ``(fn, args)`` in order) and :meth:`replay` makes them
    again."""

    def __init__(self) -> None:
        self.plan: list[tuple[Callable, tuple]] = []

    def binding(self):
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def capturing(self):
        yield

    def record(self, fn: Callable, *args) -> None:
        self.plan.append((fn, args))

    def replay(self) -> None:
        for fn, args in self.plan:
            fn(*args)


class CudaGraph:
    """One ``torch.cuda.CUDAGraph`` on ``device``, captured on a side stream
    of its own: a run binds its launches under :meth:`binding` (each
    ``bind`` takes the current stream), then records them under
    :meth:`capturing`; :meth:`replay` launches the graph on the current
    stream and adds the capture's launch counts to each of
    ``fused.COUNTS``."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        self.stream = torch.cuda.Stream(device)
        self.launches: list[dict[str, int]] = []

    def binding(self):
        return torch.cuda.stream(self.stream)

    @contextlib.contextmanager
    def capturing(self):
        before = [dict(counts) for counts in COUNTS]
        with torch.cuda.device(self.device), torch.cuda.graph(self.graph, stream=self.stream):
            yield
        self.launches = [{k: v - was[k] for k, v in counts.items() if v != was[k]}
                         for counts, was in zip(COUNTS, before)]
        for counts, captured in zip(COUNTS, self.launches):
            for k, v in captured.items():
                counts[k] -= v  # a capture launches nothing; each replay counts

    def record(self, fn: Callable, *args) -> None:
        fn(*args)

    def replay(self) -> None:
        self.graph.replay()
        for counts, captured in zip(COUNTS, self.launches):
            for k, v in captured.items():
                counts[k] += v


def capture_for(device: torch.device) -> Callable[[], CudaGraph | Recorder]:
    """The capture of a device: a CUDA graph on a CUDA device, the
    :class:`Recorder` on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return lambda: CudaGraph(device)
    return Recorder


class GraphRunner:
    """``launches`` launches of a bound program, ``chunk`` steps each, as
    replays of a period graph of :data:`PERIOD` launches (read when the
    runner is made) and a remainder graph.

    ``bind(scratch)`` binds the program (its buffers fixed) to write its
    per-step outputs into the vectors ``scratch`` (one of ``PERIOD * chunk``
    per output of ``like``: same dtype and device) and returns
    ``launch(i)``, with an optional ``launch.prologue`` of calls that start
    each graph.  Both graphs are captured here, through ``capture()``
    (:func:`capture_for`).  :meth:`run` replays them and moves each
    replay's scratch into its slice of the given outputs."""

    def __init__(self, bind: Callable[[list[torch.Tensor]], Callable[[int], None]],
                 launches: int, chunk: int, like: list[torch.Tensor],
                 capture: Callable[[], CudaGraph | Recorder]) -> None:
        period = PERIOD
        if period < 2 or period % 2:
            raise ValueError(f"the period must be even and at least 2, got {period}")
        if launches < 0:
            raise ValueError(f"launches must be >= 0, got {launches}")
        self.chunk, self.period = chunk, period
        self.reps, self.rest = divmod(launches, period)
        slots = (period if self.reps else self.rest) * chunk
        self.scratch = [torch.empty(slots, dtype=x.dtype, device=x.device) for x in like]
        self.bind, self.capture = bind, capture
        self.main = self._capture(period) if self.reps else None
        self.tail = self._capture(self.rest) if self.rest else None

    def _capture(self, n: int):
        with profiling.span("graphs.capture"):
            graph = self.capture()
            with graph.binding():
                launch = self.bind(self.scratch)
            with graph.capturing():
                for fn in getattr(launch, "prologue", ()):
                    graph.record(fn)
                for i in range(n):
                    graph.record(launch, i)
            return graph

    def run(self, outs: list[torch.Tensor]) -> None:
        """The run's launches, on the current stream: each replay's scratch
        into ``outs[j][first step : last step + 1]``.  While a profiler
        records, on a CUDA device, two CUDA events bracket the replays on
        the stream: the replay span's ``events``."""
        if len(outs) != len(self.scratch):
            raise ValueError(f"{len(self.scratch)} outputs bound, {len(outs)} given")
        with profiling.span("graphs.replay") as replay:
            timed = bool(replay) and self.scratch[0].device.type == "cuda"
            if timed:
                replay.events = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
                replay.events[0].record()
            span = self.period * self.chunk
            for r in range(self.reps):
                self.main.replay()
                for out, s in zip(outs, self.scratch):
                    out[r * span:(r + 1) * span].copy_(s)
            if self.tail is not None:
                n = self.rest * self.chunk
                self.tail.replay()
                for out, s in zip(outs, self.scratch):
                    out[self.reps * span:self.reps * span + n].copy_(s[:n])
            if timed:
                replay.events[1].record()

"""``runtime.prepare_ms``: the mean milliseconds a solve spends in
``Simulator.compiled`` (its f buffers and the capture of its CUDA graphs),
from the span around each call."""


def read(run):
    spans = run.span_seconds("runtime.Simulator.compiled")
    return 1e3 * sum(spans) / len(spans) if spans else None

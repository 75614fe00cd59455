"""``runtime.expand_ms``: the mean milliseconds of ``expand_fields`` (the
host's reconstruction of |u| and pressure from the 16-bit payload) a
solve, from the span around each call."""


def read(run):
    spans = run.span_seconds("runtime.expand_fields")
    return 1e3 * sum(spans) / len(spans) if spans else None

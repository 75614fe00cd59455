"""``runtime.capture_ms``: the milliseconds a solve spends capturing its
CUDA graphs: the program's ``graphs.capture`` spans over its
``runtime.run`` spans in the traced window (``lbmbench.program``)."""

from lbmbench import program


def read(run):
    found = program.per_solve(run, "graphs.capture")
    if found is None:
        return None
    captures, solves = found
    return 1e3 * sum(s.seconds for s in captures) / solves

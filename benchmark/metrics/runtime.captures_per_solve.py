"""``runtime.captures_per_solve``: the CUDA graphs a solve captures, work
made again every run: the count of the program's ``graphs.capture`` spans
over its ``runtime.run`` spans in the traced window."""

from lbmbench import program


def read(run):
    found = program.per_solve(run, "graphs.capture")
    if found is None:
        return None
    captures, solves = found
    return len(captures) / solves

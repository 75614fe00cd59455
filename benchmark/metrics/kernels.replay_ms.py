"""``kernels.replay_ms``: the device's milliseconds a solve between the
first graph replay's start and the last one's end, on the card's own clock:
the ``device_ms`` (two CUDA events) of the program's ``graphs.replay``
spans in the traced window, over its ``runtime.run`` spans.  Nothing where
a replay carries no ``device_ms``."""

from lbmbench import program


def read(run):
    found = program.per_solve(run, "graphs.replay")
    if found is None:
        return None
    replays, solves = found
    times = [getattr(s, "device_ms", None) for s in replays]
    if not times or None in times:
        return None
    return sum(times) / solves

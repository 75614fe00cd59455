"""``kernels.roofline_pct``: the least time the card could take for the
solves of the traced window (``lbmbench.work``: the fixed operations and
bytes of a solve over the published peaks), as a share of the profiler's
summed device time of the kernels those solves ran (every kernel that
started inside a ``Simulator.run`` span).  Nothing where the profile is not
whole or the card is not in ``peaks.json``."""

from lbmbench import work


def read(run):
    if run.device is None or not run.device.whole or run.peaks is None or not run.jobs:
        return None
    p = run.params
    least, _bound = work.least_time(p["nx"], p["ny"], p["maxIters"], run.peaks)
    kernels = run.device.in_spans("runtime.Simulator.run")
    kernel_s = sum(op.end - op.start for op in kernels)
    if kernel_s <= 0:
        return None
    return 100.0 * least * len(run.jobs) / kernel_s

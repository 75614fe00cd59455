"""``mlups``: the cell updates of every solve completed in the window, over
the window's wall seconds, in millions: all the work over all the time."""


def read(run):
    if run.entry != "solve" or not run.jobs:
        return None
    return sum(job.updates for job in run.jobs) / run.window_s / 1e6

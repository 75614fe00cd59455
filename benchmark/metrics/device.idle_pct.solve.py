"""``device.idle_pct.solve``: the share of the traced window in which no
operation ran on the card, from a profile that holds every counted
launch."""

from lbmbench import readers


def read(run):
    return readers.idle_pct(run, "solve")

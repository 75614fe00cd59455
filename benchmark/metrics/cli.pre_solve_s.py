"""``cli.pre_solve_s``: the mean seconds from ``cli.main``'s call to the
start of its ``Simulator.run`` (the parse, the geometry, the device, the
``Simulator`` and its program)."""


def read(run):
    if run.entry != "cli":
        return None
    mains = [s for s in run.spans if s.name == "cli.main"]
    solves = [s for s in run.spans if s.name == "runtime.Simulator.run"]
    gaps = []
    for main in mains:
        first = min((s.start for s in solves if main.start <= s.start < main.end), default=None)
        if first is not None:
            gaps.append(first - main.start)
    return sum(gaps) / len(gaps) if gaps else None

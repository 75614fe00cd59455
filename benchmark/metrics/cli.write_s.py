"""``cli.write_s``: the mean seconds a CLI run spends in its two writers
(``write_final_state`` and ``write_av_vels``, as ``cli`` calls them)."""


def read(run):
    runs = run.span_seconds("cli.main")
    if run.entry != "cli" or not runs:
        return None
    writes = run.span_seconds("cli.write_final_state") + run.span_seconds("cli.write_av_vels")
    return sum(writes) / len(runs)

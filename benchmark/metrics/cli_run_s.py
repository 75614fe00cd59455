"""``cli_run_s``: the window's wall seconds over the CLI runs completed in
it."""


def read(run):
    if run.entry != "cli" or not run.jobs:
        return None
    return run.window_s / len(run.jobs)

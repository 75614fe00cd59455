"""Arithmetic that more than one metric's reader shares."""


def idle_pct(run, entry: str) -> float | None:
    """100 times the share of the traced window with no device operation
    running, for a run of traffic ``entry``; nothing where the profile is
    not whole."""
    if run.entry != entry or run.device is None or not run.device.whole:
        return None
    window = run.device.window.seconds
    return 100.0 * (1.0 - run.device.busy() / window)

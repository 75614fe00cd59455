"""The program's own spans, as the metrics that read them share them.

The program under test records its spans itself
(``lbm_tpu_torch.utils.profiling``: ``spans()``, each with ``name``,
``start``, ``end``, ``id``, ``parent``, ``root``, ``attrs``, ``always`` and
``device_ms``) while a profiler records, and its set-up stages always.  Their times are
``time.perf_counter``'s, the clock of the harness's own spans, so the
``window`` span (``run.spans``) places them.  The module is the one the
harness imported from the checkout under test; a program that records no
spans (an older checkout) gives nothing to read, and so does a run off the
card, where the plain versions and ``graphs.Recorder`` stand in for what
users run.
"""

from __future__ import annotations

import importlib

MODULE = "lbm_tpu_torch.utils.profiling"


def recorded() -> list | None:
    """Every span the program has recorded in this process, or None where
    it records none."""
    try:
        module = importlib.import_module(MODULE)
    except ImportError:
        return None
    read = getattr(module, "spans", None)
    return None if read is None else read()


def _window(run):
    if run.device_name == "cpu":
        return None
    return next((s for s in run.spans if s.name == "window"), None)


def in_window(run) -> list | None:
    """The program's spans that started inside the window of a traced run
    on the card; None off the card, without a window, or where the program
    records no spans."""
    window, spans = _window(run), recorded()
    if window is None or spans is None:
        return None
    return [s for s in spans if window.start <= s.start < window.end]


def before_window(run) -> list | None:
    """The program's set-up stages (``always``) that ended before the
    window, less those inside another one: each second counted once."""
    window, spans = _window(run), recorded()
    if window is None or spans is None:
        return None
    stages = [s for s in spans if s.always and s.end is not None and s.end <= window.start]
    ids = {s.id for s in stages}
    return [s for s in stages if s.parent not in ids]


def named(spans: list, *names: str) -> list:
    return [s for s in spans if s.name in names]


def per_solve(run, name: str) -> tuple[list, int] | None:
    """The window's spans named ``name`` and its count of solves (the
    ``runtime.run`` spans); None where there is no solve to divide by."""
    spans = in_window(run)
    if spans is None:
        return None
    solves = len(named(spans, "runtime.run"))
    return (named(spans, name), solves) if solves else None


"""``runtime.expand_device_pct``: the share of the solves whose fields the
card reconstructed: 100 × the program's ``runtime.expand`` spans in the
traced window whose ``device`` is 1, over those spans.  Nothing where the
spans do not carry ``device`` (a program that reconstructs on the host
alone)."""

from lbmbench import program


def read(run):
    spans = program.in_window(run)
    if spans is None:
        return None
    expands = program.named(spans, "runtime.expand")
    if not expands or any("device" not in s.attrs for s in expands):
        return None
    return 100.0 * sum(s.attrs["device"] == 1 for s in expands) / len(expands)

"""``runtime.run_reuse_pct``: the share of the solves whose compiled run
(buffers and CUDA graphs) was kept from an earlier solve: 100 × the
program's ``runtime.prepare`` spans in the traced window whose ``reused``
is 1, over those spans.  Nothing where the spans do not carry ``reused``
(a program that compiles every run anew)."""

from lbmbench import program


def read(run):
    spans = program.in_window(run)
    if spans is None:
        return None
    prepares = program.named(spans, "runtime.prepare")
    if not prepares or any("reused" not in s.attrs for s in prepares):
        return None
    return 100.0 * sum(s.attrs["reused"] == 1 for s in prepares) / len(prepares)

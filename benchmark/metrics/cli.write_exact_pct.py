"""``cli.write_exact_pct``: the share of the values that the CLI's writers
formatted by the program's own exact conversion: 100 × (1 − the ``libc``
count over the ``values`` count) of the program's ``io.final_state`` and
``io.av_vels`` spans in the traced window.  ``libc`` counts the values
handed to the C library's ``%.12E``."""

from lbmbench import program


def read(run):
    spans = program.in_window(run)
    if spans is None:
        return None
    writes = program.named(spans, "io.final_state", "io.av_vels")
    if not writes or any("values" not in s.attrs or "libc" not in s.attrs for s in writes):
        return None
    values = sum(s.attrs["values"] for s in writes)
    if values <= 0:
        return None
    return 100.0 * (1.0 - sum(s.attrs["libc"] for s in writes) / values)

"""``cli.write_mb_s``: the rate of the CLI's writers, in 1e6 bytes a second:
the bytes that the program's ``io.final_state`` and ``io.av_vels`` spans in
the traced window put on disk, over those spans' seconds."""

from lbmbench import program


def read(run):
    spans = program.in_window(run)
    if spans is None:
        return None
    writes = program.named(spans, "io.final_state", "io.av_vels")
    seconds = sum(s.seconds for s in writes)
    if not writes or seconds <= 0 or any("bytes" not in s.attrs for s in writes):
        return None
    return sum(s.attrs["bytes"] for s in writes) / seconds / 1e6

"""``setup.program_s``: the seconds of the program's own set-up stages
before the window (the spans it records with or without a profiler: the
package's import, the kernel library's hash, build and load, the native
writers' library), each second counted once."""

from lbmbench import program


def read(run):
    stages = program.before_window(run)
    if not stages:
        return None
    return sum(s.seconds for s in stages)

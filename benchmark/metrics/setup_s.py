"""``setup_s``: seconds from the start of the process to the window's start
(torch and the CUDA context, the program's import and kernel library, the
traffic's set-up and its warm job)."""


def read(run):
    return run.setup_s

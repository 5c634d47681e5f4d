"""Seconds from the process's start to the window's start: imports, the
device context, weights, kernel loading and the warm-up item."""


def read(run):
    return run.setup_s

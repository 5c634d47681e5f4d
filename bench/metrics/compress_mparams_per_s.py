"""Dense parameters of every tensor the plan compresses, summed over the
passes begun in the window, over the summed wall time of those passes
(each ends in a device synchronisation), in millions a second."""

from benchlib.readers import field


def read(run):
    p, s = field(run, "params"), field(run, "seconds")
    return sum(p) / sum(s) / 1e6 if s else None

"""K3's share of its roofline in the serving window, in %."""

from benchlib.readers import roofline


def read(run):
    return roofline(run, "k3")

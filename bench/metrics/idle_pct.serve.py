"""The device's idle share of the traced window in %: one less the union of
the device operations' intervals over the window's length."""

from benchlib.readers import idle_pct


def read(run):
    return idle_pct(run)

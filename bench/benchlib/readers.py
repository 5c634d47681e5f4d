"""Helpers the metric readers of ``bench/metrics`` share."""

from __future__ import annotations


def roofline(run, name: str):
    """A kernel's share of its roofline in %: its calls' least time
    (``work.counts``) over their device time in the traced window; None
    where it did not run there."""
    if run.trace is None or run.ranges is None:
        return None
    dev = run.trace["by_range"].get(name, 0.0)
    if dev <= 0.0 or run.ranges.calls[name] == 0:
        return None
    return 100.0 * run.ranges.bound_s[name] / dev


def idle_pct(run):
    """The device's idle share of the traced window in %."""
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def field(run, key: str) -> list:
    """``key`` of every measured item that has it."""
    return [it[key] for it in run.items if key in it]

"""Mean prefill time of a batch (the program's ``Engine.last_timing``,
which ends in a device synchronisation), over the untraced batches."""

from benchlib.readers import field


def read(run):
    s = field(run, "prefill_s")
    return 1e3 * sum(s) / len(s) if s else None

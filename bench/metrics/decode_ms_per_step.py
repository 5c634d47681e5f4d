"""Decode time per step: the program's decode seconds over its decode
steps, summed over the untraced batches."""

from benchlib.readers import field


def read(run):
    s, n = field(run, "decode_s"), field(run, "decode_steps")
    return 1e3 * sum(s) / sum(n) if s and sum(n) else None

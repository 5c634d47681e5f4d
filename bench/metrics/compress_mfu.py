"""A compression pass's share of the card's float32 peak in %: the
operations its algorithms' equations need (``work.counts.
compress_pass_ops``) over the mean wall time of a pass."""

from benchlib.readers import field
from work import counts


def read(run):
    s = field(run, "seconds")
    if not s:
        return None
    return 100.0 * run.cell.pass_ops() / (sum(s) / len(s)) / counts.F32_FLOPS

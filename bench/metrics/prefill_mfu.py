"""The prefill's share of the card's bf16 peak in %: the operations the
compressed model's equations need (``work.counts.prefill_ops``) over the
mean prefill time."""

from benchlib.readers import field
from work import counts


def read(run):
    s = field(run, "prefill_s")
    if not s:
        return None
    return 100.0 * run.cell.prefill_ops() / (sum(s) / len(s)) / counts.BF16_FLOPS

"""Fixed-batch serving (counterpart of ``repro.serving``'s engine)."""

from repro_torch.serving.engine import (
    Engine,
    make_decode_step,
    make_prefill,
    make_prefill_chunk,
)

__all__ = ["Engine", "make_decode_step", "make_prefill", "make_prefill_chunk"]

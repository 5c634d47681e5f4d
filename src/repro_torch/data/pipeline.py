"""Data pipeline: deterministic synthetic LM streams.

Counterpart of ``repro/data/pipeline.py``.  ``batch_at(step)`` is a pure
function of (seed, step): any process can (re)compute any step's batch, so
a restarted run needs only the step counter from its checkpoint.  The draws
are the reference's numpy draws, so a batch holds the reference's tokens
(and stub embeddings) bit for bit; it is placed on the pipeline's
``device`` (default: the GPU).  With a ``mesh`` each leaf is a DTensor
whose rows are split over the dp axes (the reference's ``P(dp, None)``)
on this rank's device: each rank keeps only its rows.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models.frontends import needs_embeds

__all__ = ["SyntheticSource", "Mixture", "make_pipeline", "Pipeline"]


@dataclasses.dataclass(frozen=True)
class SyntheticSource:
    """Zipf-distributed token stream with short-range structure (bigram
    repetition) so that a model can actually reduce loss on it."""

    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.2
    repeat_p: float = 0.2

    def tokens(self, step: int, batch: int, seq: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed << 32) ^ (step + 1))
        # Zipf over a capped support for speed; map into vocab.
        support = min(self.vocab_size - 1, 4096)
        z = rng.zipf(self.zipf_a, size=(batch, seq)).astype(np.int64)
        toks = (z % support).astype(np.int32) + 1
        # structure: with prob repeat_p, copy the previous token
        rep = rng.random((batch, seq)) < self.repeat_p
        for t in range(1, seq):
            toks[:, t] = np.where(rep[:, t], toks[:, t - 1], toks[:, t])
        return toks


@dataclasses.dataclass(frozen=True)
class Mixture:
    sources: Sequence[SyntheticSource]
    weights: Sequence[float]

    def tokens(self, step: int, batch: int, seq: int) -> np.ndarray:
        rng = np.random.default_rng(step + 917)
        w = np.asarray(self.weights, np.float64)
        w = w / w.sum()
        counts = rng.multinomial(batch, w)
        outs, i0 = [], 0
        for src, c in zip(self.sources, counts):
            if c:
                outs.append(src.tokens(step * 131 + i0, int(c), seq))
            i0 += int(c)
        return np.concatenate(outs, axis=0) if outs else np.zeros((0, seq), np.int32)


class Pipeline:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, mesh=None, seed: int = 0,
                 num_sources: int = 3, device=None):
        self.cfg, self.shape, self.mesh = cfg, shape, mesh
        if mesh is not None:
            from repro_torch.distributed.sharding import NamedSharding, mesh_device, mesh_shape

            self.device = mesh_device(mesh)
            dp = tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))
            self._shard = {n: NamedSharding(mesh, (dp,) + (None,) * (n - 1)) for n in (2, 3)}
        else:
            self.device = resolve_device(device)
            self._shard = None
        self.mix = Mixture(
            [SyntheticSource(cfg.vocab_size, seed + i) for i in range(num_sources)],
            [2.0 ** -i for i in range(num_sources)],
        )

    def _place(self, arr: np.ndarray) -> torch.Tensor:
        if self._shard is None:
            return torch.from_numpy(arr).to(self.device)
        # the rows over the dp axes: only this rank's are copied
        return self._shard[arr.ndim].shard(torch.from_numpy(arr), self.device)

    def batch_at(self, step: int) -> dict:
        B, S = self.shape.global_batch, self.shape.seq_len
        toks = self.mix.tokens(step, B, S)
        if needs_embeds(self.cfg):
            # stub frontend: deterministic embeddings + labels
            rng = np.random.default_rng(step + 31337)
            emb = rng.standard_normal((B, S, self.cfg.d_model), np.float32) * 0.02
            return {"embeds": self._place(emb), "labels": self._place(toks)}
        return {"tokens": self._place(toks)}


def make_pipeline(cfg: ModelConfig, shape: ShapeConfig, mesh=None, seed: int = 0, device=None):
    return Pipeline(cfg, shape, mesh, seed, device=device)

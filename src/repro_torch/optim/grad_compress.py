"""Gradient and weight compression hooks for the training loop.

Counterpart of ``repro/optim/grad_compress.py``.

**Int8 error-feedback gradient compression**: symmetric per-tensor int8
with the quantisation residual kept and re-injected at the next step
(Seide et al.; Karimireddy et al. 2019), so the payload of a cross-host
gradient all-reduce shrinks 4x without hurting convergence.  The
quantise/dequantise pair is solver-agnostic.  The reference's training
loop never wires it into its gradient all-reduce
(``ParallelConfig.grad_compress`` is read nowhere), so the port's sharded
train step (``training/loop.py``) all-reduces the gradients uncompressed
as well.

**Periodic weight recompression** (:class:`CompressionCycle`): the host-side
hook that turns train -> compress -> serve into a cycle (docs/delta.md).
Call ``maybe_recompress(step, values)`` between train steps; every
``every`` steps it compresses the current weights, cold the first time,
then as warm-started *deltas* against the previous artifact
(:func:`repro_torch.compression.delta.delta_recompress`), re-solving only
tiles whose drift crossed the threshold.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.optim.adamw import _map

__all__ = [
    "quantize_int8",
    "dequantize_int8",
    "ef_compress",
    "ef_residual_zeros",
    "CompressionCycle",
]


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 quantisation: returns (q, scale)."""
    xf = x.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_residual_zeros(grads):
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def ef_compress(grads, residual):
    """Error-feedback compression of a gradient tree.

    Returns (tree of (q, scale), new_residual).  The caller all-reduces the
    int8 payload (sum of int32 accumulate) and dequantises."""
    def one(g, r):
        target = g.to(torch.float32) + r
        q, s = quantize_int8(target)
        return (q, s), target - dequantize_int8(q, s)

    pairs = _map(one, grads, residual)
    return _map(lambda pr: pr[0], pairs), _map(lambda pr: pr[1], pairs)


def _snapshot(values):
    """A copy of a values tree that the caller's in-place updates cannot
    reach."""
    return _map(lambda t: t.detach().clone(), values)


class CompressionCycle:
    """Periodic (delta-)recompression of the training weights.

    Host-side and stateful: call it between train steps.  The first firing
    runs a cold ``plan_compression`` + ``execute_plan``; later firings run
    :func:`repro_torch.compression.delta.delta_recompress` against the
    previous artifact with the previous *compressed* tree as the warm
    anchor, falling back to cold when the anchor is invalid
    (``ColdStartRequired``: e.g. the eligible tensors' geometry changed).

    ``maybe_recompress(step, values)`` returns ``None`` off-schedule and
    ``(compressed_values, artifact)`` when it fires; the latest pair also
    stays available as ``.compressed`` / ``.artifact`` for checkpointing
    and serving (``artifact.delta`` carries the lineage block).

    Where the reference takes a PRNG ``key``, the port takes ``seed`` (the
    restart draws of ``execute_plan`` and ``delta_recompress``) and the
    ``device`` to solve on (default: the GPU).  The port's optimisers
    update the parameters in place, so each firing compresses a snapshot of
    ``values``: the pair it keeps never changes under later train steps.
    """

    def __init__(
        self,
        policy,
        every: int,
        *,
        seed: int = 0,
        device=None,
        threshold: float | None = None,
        backend: str | None = None,
        verbose: bool = False,
    ):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.policy = policy
        self.every = every
        self.seed = seed
        self.device = resolve_device(device)
        self.threshold = threshold
        self.backend = backend
        self.verbose = verbose
        self.artifact = None
        self.compressed = None
        self.last_step = None

    def _cold(self, values):
        from repro_torch import compression as comp

        plan = comp.plan_compression(values, self.policy)
        return comp.execute_plan(plan, values, seed=self.seed, device=self.device,
                                 backend=self.backend, verbose=self.verbose)

    def recompress(self, values):
        """Compress now (cold the first time, a delta after)."""
        from repro_torch import compression as comp

        values = _snapshot(values)
        if self.artifact is None or self.compressed is None:
            pair = self._cold(values)
        else:
            kw = {} if self.threshold is None else {"threshold": self.threshold}
            try:
                pair = comp.delta_recompress(
                    self.artifact, self.compressed, values, seed=self.seed,
                    device=self.device, backend=self.backend, verbose=self.verbose, **kw,
                )
            except comp.ColdStartRequired as e:
                if self.verbose:
                    print(f"[compress-cycle] cold start forced: {e}")
                pair = self._cold(values)
        self.compressed, self.artifact = pair
        return pair

    def maybe_recompress(self, step: int, values):
        """Fire every ``self.every`` steps (step numbering starts at 1)."""
        if step < 1 or step % self.every:
            return None
        if self.last_step == step:
            return self.compressed, self.artifact
        self.last_step = step
        return self.recompress(values)

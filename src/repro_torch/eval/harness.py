"""Deterministic eval-batch runner with a cached dense baseline.

Counterpart of ``repro/eval/harness.py``.  The harness fixes a small batch
set up front, drawn through the model's frontends exactly like calibration
batches (batch i from a generator seeded by (seed, i)), and evaluates a
values tree on it eagerly, without gradients.

The eval loss is teacher-forced: cross-entropy against the dense reference
model's predictive distribution for token architectures (the reference
scores its own predictive entropy; any other tree's delta against that
baseline is the KL divergence from the reference), and the mean squared
logit deviation from the reference for embeds architectures (baseline 0).
The MoE aux loss rides along at the weight ``train_loss`` gives it.
Beside the scalar loss the harness records the per-position logit energy.

The dense baseline (reference logits and its :class:`EvalResult`) is
cached at module level, keyed by the harness parameters and a per-leaf
fingerprint of the values, so the dense forward runs once per (cfg, seed,
batches, values).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import generator, resolve_device

__all__ = ["EvalHarness", "EvalResult", "clear_baseline_cache"]

_BASELINE_CACHE: dict = {}


@dataclasses.dataclass(frozen=True)
class EvalResult:
    """Mean eval loss over the harness batches plus diagnostics."""

    loss: float            # mean over batches
    losses: tuple          # per-batch losses, batch order
    pos_energy: tuple      # per-position logit energy, mean over batches

    def to_dict(self) -> dict:
        return {
            "loss": self.loss,
            "losses": list(self.losses),
            "pos_energy": [float(f"{v:.8g}") for v in self.pos_energy],
        }


def _batch_logits(values, batch, cfg):
    from repro_torch.models import forward

    logits, _, aux = forward(values, batch, cfg)
    return logits.to(torch.float32), aux


def _batch_metrics(values, batch, ref, cfg, token_arch):
    """(loss, per-position logit energy) of one batch against the
    reference logits ``ref``."""
    logits, aux = _batch_logits(values, batch, cfg)
    energy = 0.5 * torch.mean(torch.square(logits), dim=(0, 2))
    if token_arch:
        p_ref = torch.softmax(ref, dim=-1)
        logp = torch.log_softmax(logits, dim=-1)
        loss = -torch.mean(torch.sum(p_ref * logp, dim=-1)) + 0.01 * aux
    else:
        loss = torch.mean(torch.square(logits - ref)) + 0.01 * aux
    return loss, energy


def _fingerprint(values) -> tuple:
    """Per-leaf content fingerprint: (path, sum, abs-sum) in float32."""
    from repro_torch.compression.plan import tree_paths

    out = []
    for path, leaf in tree_paths(values):
        x = leaf.to(torch.float32)
        out.append((path, float(torch.sum(x)), float(torch.sum(torch.abs(x)))))
    return tuple(out)


class EvalHarness:
    """Deterministic eval runner over fixed batches on ``device`` (default:
    the GPU).  The same (cfg, num_batches, batch, seq_len, seed, device)
    always evaluates the same inputs.  ``baseline(values)`` establishes the
    reference tree; ``evaluate`` calls measure against it."""

    def __init__(self, cfg, *, num_batches: int = 4, batch: int = 2,
                 seq_len: int = 32, seed: int = 0, device=None):
        from repro_torch.compression.autotune.calibrate import _draw
        from repro_torch.models.frontends import needs_embeds

        if num_batches < 1:
            raise ValueError(f"num_batches must be >= 1, got {num_batches}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_batches = int(num_batches)
        self.batch = int(batch)
        self.seq_len = int(seq_len)
        self.seed = int(seed)
        self.token_arch = not needs_embeds(cfg)
        self.batches = [
            _draw(cfg, self.batch, self.seq_len, generator(self.device, self.seed, i))
            for i in range(self.num_batches)
        ]
        self._ref = None       # per-batch reference logits

    def params_key(self) -> tuple:
        """The harness half of the baseline-cache key."""
        return (str(self.cfg), self.num_batches, self.batch, self.seq_len, self.seed,
                str(self.device))

    def to_dict(self) -> dict:
        """Provenance block for plan metadata and manifests."""
        return {
            "num_batches": self.num_batches,
            "batch": self.batch,
            "seq_len": self.seq_len,
            "seed": self.seed,
        }

    def baseline(self, values) -> EvalResult:
        """Establish ``values`` as the reference tree and return its eval
        result, cached per (harness params, values content)."""
        key = (self.params_key(), _fingerprint(values))
        if key not in _BASELINE_CACHE:
            with torch.no_grad():
                ref = [_batch_logits(values, b, self.cfg)[0] for b in self.batches]
            self._ref = ref
            _BASELINE_CACHE[key] = (ref, self.evaluate(values))
        self._ref = _BASELINE_CACHE[key][0]
        return _BASELINE_CACHE[key][1]

    def evaluate(self, values) -> EvalResult:
        """Mean loss and per-position energy of ``values`` against the
        reference set by :meth:`baseline`."""
        if self._ref is None:
            raise RuntimeError(
                "EvalHarness.evaluate: no reference set; call "
                "baseline(dense_values) first"
            )
        losses, energies = [], []
        with torch.no_grad():
            for batch, ref in zip(self.batches, self._ref):
                loss, energy = _batch_metrics(values, batch, ref, self.cfg, self.token_arch)
                losses.append(float(loss))
                energies.append(energy)
        mean_energy = torch.mean(torch.stack(energies), dim=0)
        return EvalResult(
            loss=float(sum(losses) / len(losses)),
            losses=tuple(losses),
            pos_energy=tuple(float(v) for v in mean_energy.tolist()),
        )


def clear_baseline_cache() -> None:
    _BASELINE_CACHE.clear()

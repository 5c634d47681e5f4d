"""Calibration: weight distortion by what the model actually computes.

Counterpart of ``repro/compression/autotune/calibrate.py``.  For ``y = x @
W`` the first-order output error of a weight perturbation dW is ``x @
dW``, so a tensor's distortion is weighted by the second moments of its
activations and of the signal propagated back to it.  One backward pass
captures both: a calibration batch drawn through the model's frontends is
pushed through ``models.forward`` and the gradient of the logit energy
``0.5 * mean(logits^2)`` is taken with respect to every float parameter by
``torch.autograd``.  Per-tensor weights are the mean squared gradient,
normalised to mean 1.0 over the eligible tensors.

The kernel hooks (K5 for prefill attention, K3/K4 for compressed layers)
have no backward: while it computes gradients, calibration clears them and
restores them after, so every gradient is the plain forward's.  The
caller's tensors are not modified: the gradients are taken on detached
aliases of them.
"""

from __future__ import annotations

import torch

from repro_torch.device import generator, resolve_device

__all__ = ["calibration_inputs", "calibration_weights"]


def _draw(cfg, batch: int, seq_len: int, g: torch.Generator) -> dict:
    from repro_torch.models.frontends import needs_embeds, stub_embeddings

    if needs_embeds(cfg):
        return {"embeds": stub_embeddings(g, cfg, batch, seq_len)}
    return {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq_len), generator=g,
                                    device=g.device)}


def calibration_inputs(cfg, *, batch: int = 4, seq_len: int = 32, seed: int = 0, device=None):
    """A calibration batch in the model's native input modality, drawn on
    ``device`` (default: the GPU) from a generator seeded by ``seed``:
    ``{"tokens"}`` for LM archs, ``{"embeds"}`` for audio/vlm."""
    return _draw(cfg, batch, seq_len, generator(resolve_device(device), seed))


def calibration_weights(
    values,
    cfg,
    inputs: dict | None = None,
    *,
    seed: int = 0,
    device=None,
    eligible: tuple | None = None,
    num_batches: int = 1,
) -> dict:
    """Per-tensor sensitivity weights from calibration forward/backward passes.

    Returns ``{path: weight}`` for every float leaf of ``values``,
    normalised to mean 1.0 over ``eligible`` paths (or over all paths).
    Batch 0 draws from a generator seeded by ``seed``, batch i > 0 from one
    seeded by (seed, i); the raw squared gradients are averaged across
    batches.  An explicit ``inputs`` batch overrides drawing and forces one
    batch."""
    from repro_torch.compression.execute import _replace
    from repro_torch.compression.plan import tree_paths
    from repro_torch.kernels.ops import kernels_off
    from repro_torch.models import forward

    if num_batches < 1:
        raise ValueError(f"num_batches must be >= 1, got {num_batches}")
    if inputs is not None:
        batches = [inputs]
    else:
        device = resolve_device(device)
        batches = [
            _draw(cfg, 4, 32, generator(device, seed) if i == 0 else generator(device, seed, i))
            for i in range(num_batches)
        ]
    paths, leaves = [], []
    for path, leaf in tree_paths(values):
        if isinstance(leaf, torch.Tensor) and leaf.dtype.is_floating_point:
            paths.append(path)
            leaves.append(leaf.detach().requires_grad_(True))
    tree = _replace(values, dict(zip(paths, leaves)))

    raw: dict = {}
    with kernels_off(), torch.enable_grad():
        for batch in batches:
            logits, _, _ = forward(tree, batch, cfg)
            energy = 0.5 * torch.mean(torch.square(logits.to(torch.float32)))
            grads = torch.autograd.grad(energy, leaves, allow_unused=True)
            for path, g in zip(paths, grads):
                v = 0.0 if g is None else float(torch.mean(torch.square(g.to(torch.float32))))
                raw[path] = raw.get(path, 0.0) + v
    raw = {p: w / len(batches) for p, w in raw.items()}
    norm_paths = [p for p in (eligible or raw) if p in raw]
    mean_w = sum(raw[p] for p in norm_paths) / max(len(norm_paths), 1)
    if mean_w <= 0.0:
        return {p: 1.0 for p in raw}
    return {p: w / mean_w for p, w in raw.items()}

"""The training step: microbatched gradient accumulation and the optimiser.

Counterpart of ``repro/training/loop.py``:

    for each microbatch:                  # gradient accumulation in accum_dtype
        loss, grads += grad(train_loss)   # remat inside the model
    grads /= n_micro
    params, opt_state = optimizer.update(...)

Gradients come from ``torch.autograd.grad`` on detached aliases of the
parameters; the optimiser then updates the state's tensors in place
(``repro_torch/optim/adamw.py``), so ``train_step`` returns a new
``TrainState`` that holds the same parameter and moment tensors.  The step
runs the model's own attention (``_chunked_attention`` under remat) with
every kernel hook cleared (``kernels.ops.kernels_off``): K5 has no backward,
and the JAX trainer registers no hook either.

Not ported yet (the multi-GPU slice): ``state_shardings`` and
``batch_sharding``, which place the state and the batch over a mesh; the
port's state lives on one device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.device import dtype_from_name, resolve_device
from repro_torch.models import init_model, train_loss
from repro_torch.models.params import split
from repro_torch.optim import adafactor, adamw

__all__ = ["TrainState", "make_optimizer", "init_train_state", "make_train_step"]


class TrainState(NamedTuple):
    step: torch.Tensor   # () int32
    params: dict         # model values tree
    opt: dict            # optimiser state tree


def make_optimizer(pcfg: ParallelConfig):
    return {"adamw": adamw, "adafactor": adafactor}[pcfg.optimizer]()


def init_train_state(seed: int, cfg: ModelConfig, pcfg: ParallelConfig,
                     device=None) -> TrainState:
    """Step 0, the model's weights from ``seed`` and zero optimiser moments,
    on ``device`` (default: the GPU; ``"meta"`` gives a template that holds
    shapes and dtypes only)."""
    device = resolve_device(device)
    values, _ = split(init_model(cfg, seed=seed, device=device))
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=device),
                      params=values, opt=make_optimizer(pcfg).init(values))


def make_train_step(cfg: ModelConfig, pcfg: ParallelConfig, lr_schedule):
    """Returns ``train_step(state, batch) -> (state, metrics)`` with metrics
    ``loss``, ``grad_norm`` and ``lr`` (0-d float32 tensors).  The batch's
    leading dim splits into ``pcfg.microbatches`` microbatches; the loss and
    the gradients are their means, the gradients summed in
    ``pcfg.accum_dtype``."""
    from repro_torch.compression.execute import _replace
    from repro_torch.compression.plan import tree_paths
    from repro_torch.kernels.ops import kernels_off

    opt = make_optimizer(pcfg)
    n_micro = pcfg.microbatches
    accum_dtype = dtype_from_name(pcfg.accum_dtype)

    def train_step(state: TrainState, batch: dict):
        paths, params = zip(*tree_paths(state.params))

        def loss_and_grads(mb):
            live = [p.detach().requires_grad_(True) for p in params]
            with kernels_off(), torch.enable_grad():
                loss = train_loss(_replace(state.params, dict(zip(paths, live))), mb, cfg)[0]
                grads = torch.autograd.grad(loss, live, allow_unused=True)
            return loss.detach(), [torch.zeros_like(p) if g is None else g
                                   for p, g in zip(params, grads)]

        micro = {k: v.reshape((n_micro, v.shape[0] // n_micro) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        if n_micro == 1:
            loss, grads = loss_and_grads({k: v[0] for k, v in micro.items()})
            grads = [g.to(accum_dtype) for g in grads]
        else:
            grads = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device) for p in params]
            loss_sum = torch.zeros((), dtype=torch.float32, device=params[0].device)
            for i in range(n_micro):
                loss, g = loss_and_grads({k: v[i] for k, v in micro.items()})
                for a, b in zip(grads, g):
                    a.add_(b.to(a.dtype))
                del g
                loss_sum = loss_sum + loss
            for a in grads:
                a.div_(n_micro)
            loss = loss_sum / n_micro

        lr = lr_schedule(state.step)
        new_params, new_opt, gnorm = opt.update(_replace(state.params, dict(zip(paths, grads))),
                                                state.opt, state.params, state.step, lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(state.step + 1, new_params, new_opt), metrics

    return train_step

"""The training step (counterpart of ``repro.training``; the sharding
helpers wait for the multi-GPU slice)."""

from repro_torch.training.loop import (
    TrainState,
    init_train_state,
    make_optimizer,
    make_train_step,
)

__all__ = ["TrainState", "init_train_state", "make_optimizer", "make_train_step"]

"""The training step and the state's placement on a mesh (counterpart of
``repro.training``)."""

from repro_torch.training.loop import (
    TrainState,
    batch_sharding,
    init_train_state,
    make_optimizer,
    make_train_step,
    state_shardings,
)

__all__ = ["TrainState", "init_train_state", "make_optimizer", "make_train_step",
           "state_shardings", "batch_sharding"]

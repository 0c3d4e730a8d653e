"""The training step: gradients (with microbatch accumulation) + AdamW."""
from .train import TrainState, copy_state_, loss_and_grads, make_train_step, train_state_init

__all__ = ["TrainState", "copy_state_", "loss_and_grads", "make_train_step", "train_state_init"]

"""The training step: gradients (with microbatch accumulation) + AdamW, and
the GPipe schedule over a ``torch.distributed`` group."""
from .pipeline import pipeline_apply, stack_stages
from .train import TrainState, copy_state_, loss_and_grads, make_train_step, train_state_init

__all__ = ["TrainState", "copy_state_", "loss_and_grads", "make_train_step", "pipeline_apply",
           "stack_stages", "train_state_init"]

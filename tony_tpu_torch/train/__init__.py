"""Training layer: distributed bootstrap, sharded train step, checkpointing,
step timing."""

from .bootstrap import init, num_slices, slice_id, task_info
from .step import (
    TrainStepBundle,
    create_train_step,
    make_forward,
    make_optimizer,
    synthetic_lm_batch,
)

__all__ = [
    "init", "task_info", "num_slices", "slice_id",
    "TrainStepBundle", "create_train_step", "make_forward", "make_optimizer",
    "synthetic_lm_batch",
]

"""Training layer on one device: bootstrap, train step, step timing."""

from .bootstrap import init, task_info
from .step import (
    TrainStepBundle,
    create_train_step,
    make_forward,
    make_optimizer,
    mesh_from_string,
    synthetic_lm_batch,
)

__all__ = [
    "init", "task_info", "TrainStepBundle", "create_train_step",
    "make_forward", "make_optimizer", "mesh_from_string",
    "synthetic_lm_batch",
]

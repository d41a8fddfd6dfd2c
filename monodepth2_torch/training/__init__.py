"""Training, port of monodepth2_tpu/training: config, multi-scale loss, train
state, the train step and the scanned (CUDA-graph) step, the checkpoint and
the fit loop."""

from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .config import TrainConfig, TrainContext
from .loss import train_loss
from .state import TrainState, create_train_state, make_scanned_train_step, make_train_step

__all__ = [
    "TrainConfig",
    "TrainContext",
    "train_loss",
    "TrainState",
    "create_train_state",
    "make_train_step",
    "make_scanned_train_step",
    "save_checkpoint",
    "load_checkpoint",
    "latest_checkpoint",
]

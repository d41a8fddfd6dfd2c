"""Training, port of monodepth2_tpu/training: config, multi-scale loss, train
state and step. The checkpoint, the fit loop and the scanned step come in
later slices of the port."""

from .config import TrainConfig, TrainContext
from .loss import train_loss
from .state import TrainState, create_train_state, make_train_step

__all__ = [
    "TrainConfig",
    "TrainContext",
    "train_loss",
    "TrainState",
    "create_train_state",
    "make_train_step",
]

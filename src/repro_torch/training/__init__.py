"""Training substrate of the port: optimizers, DP-SGD, FedAvg, and the
serving step."""
from .optimizer import Optimizer, adafactor, adamw, make_optimizer, sgd
from .dp_sgd import add_noise, clip_by_global_norm, dp_gradients, global_norm
from .train_loop import (DPConfig, TrainConfig, make_loss_fn, make_state,
                         serve_step)
from .fedavg import FedAvgConfig, aggregate, client_update, fl_round

__all__ = [
    "Optimizer", "adafactor", "adamw", "make_optimizer", "sgd", "add_noise",
    "clip_by_global_norm", "dp_gradients", "global_norm", "DPConfig",
    "TrainConfig", "make_loss_fn", "make_state", "FedAvgConfig",
    "aggregate", "client_update", "fl_round", "serve_step",
]

"""Training substrate of the port: optimizers, DP-SGD, the training and
serving steps, FedAvg, compression."""
from .optimizer import Optimizer, adafactor, adamw, make_optimizer, sgd
from .dp_sgd import add_noise, clip_by_global_norm, dp_gradients, global_norm
from .train_loop import (DPConfig, TrainConfig, make_loss_fn, make_state,
                         serve_step, train_step)
from .compression import (compress_tree, compressed_mean, compressed_psum,
                          decompress_tree, dequantize_int8, quantize_int8)
from .fedavg import FedAvgConfig, aggregate, client_update, fl_round

__all__ = [
    "Optimizer", "adafactor", "adamw", "make_optimizer", "sgd", "add_noise",
    "clip_by_global_norm", "dp_gradients", "global_norm", "DPConfig",
    "TrainConfig", "make_loss_fn", "make_state", "serve_step", "train_step",
    "compress_tree", "compressed_mean", "compressed_psum", "decompress_tree",
    "dequantize_int8", "quantize_int8", "FedAvgConfig", "aggregate",
    "client_update", "fl_round",
]

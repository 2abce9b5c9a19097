"""Model substrate of the port: the dense transformer on PyTorch."""
from .transformer import (Transformer, clone_model, forward, init_model,
                          lm_loss, params_from_jax, unflatten)

__all__ = ["Transformer", "clone_model", "forward", "init_model", "lm_loss",
           "params_from_jax", "unflatten"]

"""Model substrate of the port: the transformer on PyTorch (attention,
RG-LRU and xLSTM blocks), and its KV-cache serving path."""
from .transformer import (Transformer, clone_model, forward, init_model,
                          lm_loss, params_from_jax, unflatten)
from .kv_cache import decode_step, forward_with_cache, init_cache

__all__ = ["Transformer", "clone_model", "forward", "init_model", "lm_loss",
           "params_from_jax", "unflatten", "decode_step",
           "forward_with_cache", "init_cache"]

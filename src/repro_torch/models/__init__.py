"""Model substrate of the port: the transformer on PyTorch (attention,
RG-LRU, xLSTM and mixture-of-experts blocks), and its KV-cache serving
path."""
from .transformer import (Transformer, clone_model, encode, forward,
                          init_model, lm_loss, params_from_jax, unflatten)
from .kv_cache import decode_step, forward_with_cache, init_cache
from .moe import aux_load_balance_loss, moe_apply, moe_capacity

__all__ = ["Transformer", "clone_model", "encode", "forward", "init_model",
           "lm_loss", "params_from_jax", "unflatten", "decode_step",
           "forward_with_cache", "init_cache", "aux_load_balance_loss",
           "moe_apply", "moe_capacity"]

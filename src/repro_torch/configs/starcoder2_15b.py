"""starcoder2-15b — dense GQA, RoPE.  [arXiv:2402.19173; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    kv_heads=4,
    head_dim=128,
    d_ff=24_576,
    vocab=49_152,
    qkv_bias=True,
    rope_theta=999_999.0,
    norm="layernorm",
    act="gelu",
    source="arXiv:2402.19173; hf",
)

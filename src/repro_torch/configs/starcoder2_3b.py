"""starcoder2-3b — dense GQA, RoPE.  [arXiv:2402.19173; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    kv_heads=2,
    head_dim=128,
    d_ff=12_288,
    vocab=49_152,
    qkv_bias=True,
    rope_theta=999_999.0,
    norm="layernorm",
    act="gelu",
    source="arXiv:2402.19173; hf",
)

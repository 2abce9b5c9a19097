"""qwen2.5-32b — dense GQA with QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    kv_heads=8,
    head_dim=128,
    d_ff=27_648,
    vocab=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    act="silu",
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)

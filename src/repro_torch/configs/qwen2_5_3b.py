"""qwen2.5-3b — dense GQA with QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    kv_heads=2,
    head_dim=128,
    d_ff=11_008,
    vocab=151_936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    act="silu",
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)

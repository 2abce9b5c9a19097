"""recurrentgemma-2b — RG-LRU + local attention hybrid, 1:2 attn:recurrent.
[arXiv:2402.19427; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256_000,
    pattern=(("rec", False), ("rec", False), ("local", False)),
    window=2048,
    norm="rmsnorm",
    act="geglu",
    rope_theta=10_000.0,
    source="arXiv:2402.19427; hf",
)

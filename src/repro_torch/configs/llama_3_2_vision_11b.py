"""llama-3.2-vision-11b — text backbone with cross-attn image layers every
5th layer; vision tower is a STUB (input_specs provides patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab=128_256,
    pattern=(("attn", False),) * 4 + (("xattn", False),),
    cross_memory_len=1601,     # 1 tile x (1600 patches + cls)
    norm="rmsnorm",
    act="silu",
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)

"""mixtral-8x22b — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from .base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    kv_heads=8,
    head_dim=128,
    d_ff=16_384,               # per-expert width
    vocab=32_768,
    pattern=(("swa", True),),
    window=4096,
    moe=MoESpec(n_experts=8, top_k=2, capacity_factor=1.25),
    norm="rmsnorm",
    act="silu",
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088; hf",
)

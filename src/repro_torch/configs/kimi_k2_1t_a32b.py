"""kimi-k2-1t-a32b — trillion-param MoE: 384 experts top-8 + 1 shared expert,
leading dense layer (DeepSeek-style).  [arXiv:2501.kimi2; unverified]"""
from .base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    kv_heads=8,
    head_dim=128,
    d_ff=2048,                 # per-expert width
    dense_ff=18_432,           # the single dense layer's width
    vocab=163_840,
    prefix=(("attn", False),),
    pattern=(("attn", True),),
    moe=MoESpec(n_experts=384, top_k=8, capacity_factor=1.25, n_shared=1),
    norm="rmsnorm",
    act="silu",
    rope_theta=50_000.0,
    source="arXiv:2501.kimi2; unverified",
)

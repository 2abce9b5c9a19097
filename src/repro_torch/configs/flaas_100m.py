"""flaas-100m — the paper's own workload scale: a ~100M dense LM used as the
FL pipeline payload in the end-to-end training example (examples/train_fl).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="flaas-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    kv_heads=4,
    head_dim=64,
    d_ff=2048,
    vocab=32_000,
    norm="rmsnorm",
    act="silu",
    source="paper §VI workload scale",
)

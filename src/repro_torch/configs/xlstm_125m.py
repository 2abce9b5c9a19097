"""xlstm-125m — sLSTM + mLSTM blocks (d_ff=0: blocks own their projections).
[arXiv:2405.04517; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    kv_heads=4,
    d_ff=0,
    vocab=50_304,
    # 3:1 mLSTM:sLSTM cycle (xLSTM[7:1]-style mix scaled to 12 layers)
    pattern=(("mlstm", False), ("mlstm", False), ("mlstm", False),
             ("slstm", False)),
    norm="layernorm",
    act="gelu",
    source="arXiv:2405.04517; unverified",
)

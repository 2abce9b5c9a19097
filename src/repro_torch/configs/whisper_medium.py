"""whisper-medium — encoder-decoder; conv audio frontend is a STUB
(input_specs provides precomputed frame embeddings).  [arXiv:2212.04356]

Decoder layers are (self-attn + cross-attn + MLP); prefill shapes encode
`seq_len` stub frames and prefill a 448-token decoder prompt; decode shapes
attend one new token against the 448 self-cache and the seq_len cross memory.
"""
from .base import ArchConfig, EncoderSpec

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=51_865,
    pattern=(("encdec", False),),
    encoder=EncoderSpec(n_layers=24),
    cross_memory_len=1500,
    qkv_bias=True,
    norm="layernorm",
    act="gelu",
    source="arXiv:2212.04356; unverified",
)

DECODER_PROMPT_LEN = 448

"""Architecture & shape configuration schema.

Every assigned architecture is an `ArchConfig`; layers are declared as a
`prefix` (unrolled, e.g. Kimi's leading dense layer) plus a repeating
`pattern` cycle (scanned — keeps the HLO small for 40-64-layer models).

Layer kinds:
  "attn"   — global causal attention        "swa"   — sliding-window attention
  "local"  — local attention (same math as swa; griffin naming)
  "rec"    — RG-LRU recurrent block          "mlstm" — xLSTM matrix-LSTM block
  "slstm"  — xLSTM scalar-LSTM block         "xattn" — cross-attn (+MLP) block
  "encdec" — decoder layer with self-attn + cross-attn + MLP (whisper)

Each pattern entry is (kind, uses_moe).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

LayerSpec = Tuple[str, bool]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    n_shared: int = 0          # always-on shared experts (DeepSeek/Kimi style)


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    n_layers: int              # whisper audio encoder depth (frontend is a stub)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int                  # dense MLP width (or per-expert width for MoE)
    vocab: int
    head_dim: Optional[int] = None
    pattern: Tuple[LayerSpec, ...] = (("attn", False),)
    prefix: Tuple[LayerSpec, ...] = ()
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"      # rmsnorm | layernorm
    act: str = "silu"          # silu (swiglu) | geglu | gelu
    window: Optional[int] = None
    moe: Optional[MoESpec] = None
    dense_ff: Optional[int] = None   # d_ff of non-MoE layers in a MoE model
    encoder: Optional[EncoderSpec] = None
    cross_memory_len: int = 0  # default memory length for xattn/encdec archs
    mlstm_chunk: int = 256
    tie_embeddings: bool = False
    moe_dispatch_groups: int = 1   # set to the DP shard count when distributed
    source: str = ""           # provenance tag

    # ------------------------------------------------------------- derived
    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        """Full per-layer (kind, moe) list of length n_layers."""
        body = self.n_layers - len(self.prefix)
        assert body >= 0
        cyc = tuple(self.pattern[i % len(self.pattern)] for i in range(body))
        return self.prefix + cyc

    @property
    def n_groups(self) -> int:
        return (self.n_layers - len(self.prefix)) // len(self.pattern)

    @property
    def n_suffix(self) -> int:
        return (self.n_layers - len(self.prefix)) % len(self.pattern)

    def supports_long_context(self) -> bool:
        """True if decode state is O(window)/O(1) — ssm/hybrid/swa archs."""
        kinds = {k for k, _ in self.layer_specs()}
        full_attn = "attn" in kinds or "xattn" in kinds or "encdec" in kinds
        return not full_attn

    def is_encoder_decoder(self) -> bool:
        return self.encoder is not None


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


LM_SHAPES = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)


def shapes_for(cfg: ArchConfig):
    """The shape cells this arch runs; long_500k only for sub-quadratic archs
    (DESIGN.md §5)."""
    out = []
    for s in LM_SHAPES:
        if s.name == "long_500k" and not cfg.supports_long_context():
            continue
        out.append(s)
    return tuple(out)


def reduced(cfg: ArchConfig, n_layers=None) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    period = len(cfg.pattern)
    nl = n_layers or max(len(cfg.prefix) + 2 * period, 2)
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, n_experts=min(cfg.moe.n_experts, 4),
                                  top_k=min(cfg.moe.top_k, 2))
    enc = None
    if cfg.encoder is not None:
        enc = EncoderSpec(n_layers=2)
    heads = min(cfg.n_heads, 4)
    kv = max(1, min(cfg.kv_heads, heads))
    while heads % kv:
        kv -= 1
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", n_layers=nl, d_model=64,
        n_heads=heads, kv_heads=kv, head_dim=16,
        d_ff=128, dense_ff=128 if cfg.dense_ff else None, vocab=256,
        window=min(cfg.window, 8) if cfg.window else None,
        moe=moe, encoder=enc, cross_memory_len=16 if cfg.cross_memory_len else 0,
        mlstm_chunk=8)

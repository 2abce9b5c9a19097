"""Mesh-specialised configurations, the inputs, caches and training
state as shapes without allocation, and the serving cells' specs: the
parts of ``repro/launch/specs.py`` that are not XLA lowering.

``repro``'s ``build_cell`` pairs each (arch, shape, mesh) with a function
to lower and its in/out shardings for its dry-run and roofline tools;
the port's H100 counterparts of those tools are not written yet, so
:func:`serve_cell` gives the prefill and decode cells' specs alone.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..configs import get_arch
from ..configs.base import ArchConfig, ShapeSpec
from ..configs.whisper_medium import DECODER_PROMPT_LEN
from ..distributed.sharding import (batch_pspecs, cache_pspecs, dp_axes,
                                    dp_size, param_pspecs)
from ..models.kv_cache import meta_cache
from ..models.transformer import Transformer
from ..training.train_loop import DPConfig, TrainConfig, make_state


def dispatch_groups(n_dp: int, tokens: int) -> int:
    """MoE dispatch groups on ``n_dp`` DP shards: ``n_dp``, halved until
    it divides ``tokens``."""
    g = n_dp
    while g > 1 and tokens % g:
        g //= 2
    return max(g, 1)


def arch_for_mesh(cfg: ArchConfig, mesh, shape: ShapeSpec) -> ArchConfig:
    """Mesh- and shape-specialised config (MoE dispatch groups = DP
    shards, halved until they divide the batch's tokens; whisper's cross
    memory = the cell's sequence length)."""
    upd: Dict[str, Any] = {}
    if cfg.moe is not None:
        b_tokens = shape.global_batch * (shape.seq_len
                                         if shape.kind != "decode" else 1)
        upd["moe_dispatch_groups"] = dispatch_groups(dp_size(mesh), b_tokens)
    if cfg.encoder is not None:
        upd["cross_memory_len"] = shape.seq_len
    if upd:
        cfg = dataclasses.replace(cfg, **upd)
    return cfg


def train_config_for(cfg: ArchConfig, shape: ShapeSpec) -> TrainConfig:
    """Per-arch training config: Adafactor without a float32 master for
    the 1T MoE, AdamW elsewhere; bfloat16 parameters; 8 microbatches
    where the batch divides."""
    kimi = cfg.name.startswith("kimi")
    n_micro = 8 if shape.global_batch % 8 == 0 else 1
    return TrainConfig(optimizer="adafactor" if kimi else "adamw",
                       dp=DPConfig(n_micro=n_micro),
                       param_dtype="bfloat16", keep_master=not kimi)


def state_specs(cfg: ArchConfig, tcfg: TrainConfig) -> Dict[str, Any]:
    """The full training state of ``cfg`` under ``tcfg`` on the ``meta``
    device: every shape and dtype, nothing allocated."""
    return make_state(0, cfg, tcfg, device="meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_specs(B: int, S: int) -> Dict[str, torch.Tensor]:
    return {"tokens": _meta((B, S), torch.int32),
            "labels": _meta((B, S), torch.int32)}


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """The batch (train, prefill) or the ``(token, pos)`` (decode) of a
    cell as ``meta`` tensors, ``repro``'s shapes and dtypes: int32
    tokens, bfloat16 memory and encoder frames (1500 frames for
    training, the cell's length for the prefill, whose decoder prompt is
    whisper's 448 tokens)."""
    B, S = shape.global_batch, shape.seq_len
    D, bf16 = cfg.d_model, torch.bfloat16
    if shape.kind == "train":
        b = _token_specs(B, S)
        if cfg.encoder is not None:
            b["enc_frames"] = _meta((B, 1500, D), bf16)
        elif cfg.cross_memory_len:
            b["memory"] = _meta((B, cfg.cross_memory_len, D), bf16)
        return b
    if shape.kind == "prefill":
        if cfg.encoder is not None:
            return {"tokens": _meta((B, DECODER_PROMPT_LEN), torch.int32),
                    "enc_frames": _meta((B, S, D), bf16)}
        b = {"tokens": _meta((B, S), torch.int32)}
        if cfg.cross_memory_len:
            b["memory"] = _meta((B, cfg.cross_memory_len, D), bf16)
        return b
    if shape.kind == "decode":
        return {"token": _meta((B, 1), torch.int32),
                "pos": _meta((), torch.int32)}
    raise ValueError(shape.kind)


def cache_specs(cfg: ArchConfig, shape: ShapeSpec):
    """The decode cache of a cell as ``meta`` tensors: ``init_cache`` on
    a ``meta`` bfloat16 model (:func:`repro_torch.models.kv_cache.
    meta_cache`), ``cache_len`` the cell's length (whisper's 448-token
    decoder prompt, its encoder over the cell's length of frames)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.encoder is not None:
        return meta_cache(cfg, B, DECODER_PROMPT_LEN, memory_len=S)
    return meta_cache(cfg, B, S)


@dataclasses.dataclass
class ServeCell:
    """The specs of one serving (arch x shape x mesh) cell: ``in_specs``
    and ``out_specs`` as ``repro``'s ``build_cell`` gives its in- and
    out-shardings (prefill: ``(params, batch)`` -> logits; decode:
    ``(params, token, cache, pos)`` -> ``(logits, cache)``)."""
    arch: ArchConfig
    shape: ShapeSpec
    in_specs: tuple
    out_specs: Any


def serve_cell(arch_name: str, shape: ShapeSpec, mesh) -> ServeCell:
    """The prefill or decode cell's specs: the parameters by
    ``param_pspecs`` (of a ``meta`` model), the batch by
    ``batch_pspecs``, the cache by ``cache_pspecs``; the prefill's logits
    [B, S, V] with the batch on the DP axes where it divides and the
    vocabulary on 'model' where it divides."""
    cfg = arch_for_mesh(get_arch(arch_name), mesh, shape)
    p_specs = param_pspecs(Transformer(cfg, device="meta",
                                       dtype=torch.bfloat16), cfg, mesh)
    if shape.kind == "prefill":
        b_specs = batch_pspecs(input_specs(cfg, shape), mesh)
        dp = dp_axes(mesh)
        tp = mesh.shape["model"]
        out = (((dp[0] if len(dp) == 1 else dp)
                if shape.global_batch % dp_size(mesh) == 0 else None),
               None, "model" if cfg.vocab % tp == 0 else None)
        return ServeCell(cfg, shape, (p_specs, b_specs), out)
    if shape.kind != "decode":
        raise ValueError(f"{shape.kind}: serve_cell takes prefill and "
                         "decode cells")
    c_specs = cache_pspecs(cache_specs(cfg, shape), mesh, shape.global_batch)
    tok = batch_pspecs({"token": input_specs(cfg, shape)["token"]},
                       mesh)["token"]
    return ServeCell(cfg, shape, (p_specs, tok, c_specs, ()), ((), c_specs))

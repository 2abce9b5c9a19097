"""Transformer backbone on PyTorch: the ``attn``/``swa``/``local`` blocks
with a dense MLP (the families ``flaas-100m`` needs).

``repro`` keeps parameters as a pytree and stacks the repeating body for
``lax.scan``; the port keeps them in an ``nn.Module`` -- a ``ModuleList``
of blocks, in layer order (prefix, body group by group, suffix) -- whose
``nn.ParameterDict``s carry ``repro``'s names (``embed.table``,
``blocks.3.attn.wq``, ``final_norm.scale``, ``lm_head.w``).  Every
parameter is a view into one flat float32 buffer, ``model.flat``, so DP
code can read, write and difference a whole model as one vector without
copying it piecewise.

``remat`` trades memory for recompute and leaves values unchanged; at the
sizes this slice runs (``flaas-100m``, batch 2 x 256 tokens) the port
keeps every activation and ignores it.

Entry points:

  init_model(cfg, seed, device)     -> Transformer (random, torch.Generator)
  params_from_jax(tree, cfg, device)-> Transformer holding repro's values
  forward(params, tokens, cfg)      -> logits [B, S, vocab] (float32)
  lm_loss(logits, labels, mask)     -> mean token cross-entropy
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..configs.base import ArchConfig
from . import layers as L

_PORTED_KINDS = ("attn", "swa", "local")


def _check_ported(cfg: ArchConfig) -> None:
    for kind, use_moe in cfg.layer_specs():
        if kind not in _PORTED_KINDS or use_moe:
            raise NotImplementedError(
                f"block {kind!r}{' with MoE' if use_moe else ''} is not "
                "ported yet (ROADMAP.md, Queue 1)")
    if cfg.encoder is not None:
        raise NotImplementedError("encoder-decoder models are not ported yet")


def _pdict(shapes: Dict[str, tuple], device) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: nn.Parameter(torch.empty(s, dtype=torch.float32, device=device))
        for k, s in shapes.items()})


def _norm_shapes(d: int, kind: str) -> Dict[str, tuple]:
    return {"scale": (d,)} if kind == "rmsnorm" else \
        {"scale": (d,), "bias": (d,)}


class Block(nn.Module):
    """One attention block: ``norm1``, ``attn``, ``norm2``, ``mlp``."""

    def __init__(self, kind: str, cfg: ArchConfig, device):
        super().__init__()
        self.kind = kind
        D, H, KH, dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.dh
        attn = {"wq": (D, H * dh), "wk": (D, KH * dh), "wv": (D, KH * dh),
                "wo": (H * dh, D)}
        if cfg.qkv_bias:
            attn.update(bq=(H * dh,), bk=(KH * dh,), bv=(KH * dh,))
        width = cfg.dense_ff or cfg.d_ff
        mlp = {"w_up": (D, width), "w_down": (width, D)}
        if cfg.act in ("silu", "swiglu"):
            mlp["w_gate"] = (D, width)
        self.norm1 = _pdict(_norm_shapes(D, cfg.norm), device)
        self.attn = _pdict(attn, device)
        self.norm2 = _pdict(_norm_shapes(D, cfg.norm), device)
        self.mlp = _pdict(mlp, device)

    def forward(self, h, cfg: ArchConfig, positions, causal: bool = True):
        window = cfg.window if self.kind in ("swa", "local") else None
        x = L.apply_norm(h, self.norm1, cfg.norm)
        q, k, v = L.qkv_project(x, self.attn, cfg.n_heads, cfg.kv_heads,
                                cfg.dh)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        out = L.chunked_attention(q, k, v, causal=causal, window=window)
        B, S = h.shape[:2]
        h = h + out.reshape(B, S, -1) @ self.attn["wo"]
        return h + L.mlp(L.apply_norm(h, self.norm2, cfg.norm), self.mlp,
                         cfg.act)


class Transformer(nn.Module):
    """The model's parameters (uninitialised: :func:`init_model` or
    :func:`params_from_jax` fill them) and its training forward."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        _check_ported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = _pdict({"table": (cfg.vocab, cfg.d_model)}, dev)
        self.blocks = nn.ModuleList(
            Block(kind, cfg, dev) for kind, _ in cfg.layer_specs())
        self.final_norm = _pdict(_norm_shapes(cfg.d_model, cfg.norm), dev)
        if not cfg.tie_embeddings:
            self.lm_head = _pdict({"w": (cfg.d_model, cfg.vocab)}, dev)
        # re-point every parameter at its slice of one flat buffer
        params = list(self.parameters())
        self.flat = torch.empty(sum(p.numel() for p in params),
                                dtype=torch.float32, device=dev)
        off = 0
        for p in params:
            p.data = self.flat[off:off + p.numel()].view_as(p)
            off += p.numel()

    def forward(self, tokens):
        cfg = self.cfg
        h = L.embed(tokens, self.embed)
        pos = torch.arange(tokens.shape[1], device=h.device)
        for blk in self.blocks:
            h = blk(h, cfg, pos)
        h = L.apply_norm(h, self.final_norm, cfg.norm)
        if cfg.tie_embeddings:
            return (h @ self.embed["table"].T).float()
        return L.lm_head(h, self.lm_head)


def clone_model(model: Transformer) -> Transformer:
    """A new model of the same configuration and device holding a copy of
    ``model``'s values."""
    out = Transformer(model.cfg, device=model.flat.device)
    with torch.no_grad():
        out.flat.copy_(model.flat)
    return out


def unflatten(model: Transformer, vec: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
    """Views of a flat ``[P]`` vector as ``{name: tensor}``, laid out as
    ``model``'s parameters."""
    out, off = {}, 0
    for name, p in model.named_parameters():
        out[name] = vec[off:off + p.numel()].view_as(p)
        off += p.numel()
    return out


@torch.no_grad()
def init_model(cfg: ArchConfig, seed: int = 0, device="cuda") -> Transformer:
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device``, with ``repro``'s scheme: dense weights
    ``N(0, 1/fan_in)``, embeddings ``N(0, 0.02^2)``, norm scales one,
    biases zero.  (``repro`` draws from ``jax.random``; the values
    differ, the distribution does not.)"""
    model = Transformer(cfg, device=device)
    gen = torch.Generator(device=model.flat.device).manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            p.fill_(1.0)
        elif leaf in ("bias", "bq", "bk", "bv"):
            p.zero_()
        else:
            p.normal_(generator=gen)
            p.mul_(0.02 if leaf == "table" else 1.0 / math.sqrt(p.shape[0]))
    return model


@torch.no_grad()
def params_from_jax(tree: Dict[str, Any], cfg: ArchConfig,
                    device="cuda") -> Transformer:
    """A model holding the values of ``repro``'s parameter pytree (numpy
    arrays, e.g. from ``jax.device_get(init_model(...))``): ``prefix``
    blocks, then the stacked ``body`` (``[n_groups, ...]`` per pattern
    position) group by group, then ``suffix``."""
    model = Transformer(cfg, device=device)
    P = len(cfg.pattern)
    blocks = list(tree["prefix"])
    for g in range(cfg.n_groups):
        for pos in range(P):
            blocks.append({k: {n: np.asarray(a)[g] for n, a in sub.items()}
                           for k, sub in tree["body"][pos].items()})
    blocks += list(tree["suffix"])
    src = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    if not cfg.tie_embeddings:
        src["lm_head"] = tree["lm_head"]
    for i, blk in enumerate(blocks):
        for k, sub in blk.items():
            src[f"blocks.{i}.{k}"] = sub
    for name, p in model.named_parameters():
        mod, leaf = name.rsplit(".", 1)
        a = np.asarray(src[mod][leaf], dtype=np.float32)
        if a.shape != tuple(p.shape):
            raise ValueError(f"{name}: shape {a.shape} != {tuple(p.shape)}")
        p.copy_(torch.tensor(a))
    return model


def forward(params: Transformer, tokens, cfg: Optional[ArchConfig] = None):
    """Training forward -> logits [B, S, vocab] (float32).  ``cfg``, where
    given, must be the model's own."""
    if cfg is not None and cfg != params.cfg:
        raise ValueError("cfg differs from the model's configuration")
    return params(tokens)


def lm_loss(logits, labels, mask=None):
    """Mean token cross-entropy; logits float32 [B,S,V], labels [B,S]."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)

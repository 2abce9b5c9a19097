"""Transformer backbone on PyTorch: the ``attn``/``swa``/``local`` blocks
and the RG-LRU ``rec`` block, each with a dense MLP (the families
``flaas-100m`` and ``recurrentgemma-2b`` need).

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

A block has one code path, :func:`apply_block`, for the training forward,
the prefill and the decode step (:mod:`repro_torch.models.kv_cache`); only
the attention call and the recurrent state it is given differ between
them.  A ``rec`` block trains on both devices: under autograd the scan
runs its twin's backward on the CPU and the Hopper backward kernel on the
card (:mod:`repro_torch.kernels.rg_lru`).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..configs.base import ArchConfig
from . import layers as L
from . import recurrent as R

_PORTED_KINDS = ("attn", "swa", "local", "rec")


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


def _rg_shapes(D: int) -> Dict[str, tuple]:
    """The RG-LRU's leaves in ``repro``'s order (``init_rglru_block``)."""
    return {"w_x": (D, D), "w_gate_br": (D, D),
            "conv_w": (R.CONV_WIDTH, D), "conv_b": (D,), "w_a": (D, D),
            "b_a": (D,), "w_i": (D, D), "b_i": (D,), "lambda": (D,),
            "w_out": (D, D)}


class Block(nn.Module):
    """One block: ``norm1``, the mixer (``attn`` for ``attn``/``swa``/
    ``local``, ``rg`` for ``rec``), ``norm2``, ``mlp``."""

    def __init__(self, kind: str, cfg: ArchConfig, device):
        super().__init__()
        self.kind = kind
        D, H, KH, dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.dh
        width = cfg.dense_ff or cfg.d_ff
        mlp = {"w_up": (D, width), "w_down": (width, D)}
        if cfg.act in ("silu", "swiglu"):
            mlp["w_gate"] = (D, width)
        self.norm1 = _pdict(_norm_shapes(D, cfg.norm), device)
        if kind == "rec":
            self.rg = _pdict(_rg_shapes(D), device)
        else:
            attn = {"wq": (D, H * dh), "wk": (D, KH * dh),
                    "wv": (D, KH * dh), "wo": (H * dh, D)}
            if cfg.qkv_bias:
                attn.update(bq=(H * dh,), bk=(KH * dh,), bv=(KH * dh,))
            self.attn = _pdict(attn, device)
        self.norm2 = _pdict(_norm_shapes(D, cfg.norm), device)
        self.mlp = _pdict(mlp, device)

    def forward(self, h, cfg: ArchConfig, positions, causal: bool = True):
        return apply_block_train(h, self, self.kind, cfg,
                                 positions=positions, causal=causal)


# (q, k, v, window) -> attention output [B, S, H, dh]
Attend = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, Optional[int]],
                  torch.Tensor]


def _ffn_apply(h, p: Block, cfg: ArchConfig):
    """The block's dense MLP (``repro``'s ``_ffn_apply``; MoE is not
    ported)."""
    return L.mlp(h, p.mlp, cfg.act)


def apply_block(h, p: Block, kind: str, cfg: ArchConfig, *, positions,
                attend: Optional[Attend],
                state: Optional[R.State] = None):
    """One block: the pre-norm mixer, then the pre-norm MLP, each added to
    the residual.  For ``attn``/``swa``/``local`` the mixer is attention on
    the roped projections, ``attend(q, k, v, window)`` (``window`` the
    config's for ``swa``/``local``, None for ``attn``), and the block's
    new state is ``(k, v)``, the roped keys and values [B, S, KH, dh].
    For ``rec`` it is the RG-LRU from ``state`` (the decode state, None at
    a sequence's start), and the new state ``(conv, h)``.  Returns ``(h,
    new state)``."""
    x = L.apply_norm(h, p.norm1, cfg.norm)
    if kind == "rec":
        out, new = R.rglru_block(x, p.rg, state)
    else:
        window = cfg.window if kind in ("swa", "local") else None
        q, k, v = L.qkv_project(x, p.attn, cfg.n_heads, cfg.kv_heads,
                                cfg.dh)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        B, S = h.shape[:2]
        out = attend(q, k, v, window).reshape(B, S, -1) @ p.attn["wo"]
        new = (k, v)
    h = h + out
    return h + _ffn_apply(L.apply_norm(h, p.norm2, cfg.norm), p, cfg), new


def apply_block_train(h, p: Block, kind: str, cfg: ArchConfig, *,
                      positions, causal: bool = True):
    """The training block: :func:`apply_block` with
    :func:`repro_torch.models.layers.chunked_attention` (autograd), a
    ``rec`` block from a zero state."""
    return apply_block(
        h, p, kind, cfg, positions=positions,
        attend=lambda q, k, v, window: L.chunked_attention(
            q, k, v, causal=causal, window=window))[0]


def logits_head(params: "Transformer", h):
    """Final norm and the LM head (or the tied embedding): float32
    logits."""
    cfg = params.cfg
    h = L.apply_norm(h, params.final_norm, cfg.norm)
    if cfg.tie_embeddings:
        return (h @ params.embed["table"].T).float()
    return L.lm_head(h, params.lm_head)


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
        return logits_head(self, h)


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
    ``N(0, 1/fan_in)``, embeddings and the RG-LRU's ``conv_w`` ``N(0,
    0.02^2)``, norm scales one, biases zero, and the RG-LRU's ``lambda``
    griffin's: ``log(u^(1/8) / (1 - u^(1/8)))`` for ``u ~ U(0.9, 0.999)``,
    so that ``sigmoid(lambda)^8`` lies in (0.9, 0.999).  (``repro`` draws
    from ``jax.random``; the values differ, the distribution does
    not.)"""
    model = Transformer(cfg, device=device)
    gen = torch.Generator(device=model.flat.device).manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            p.fill_(1.0)
        elif leaf in ("bias", "bq", "bk", "bv", "conv_b", "b_a", "b_i"):
            p.zero_()
        elif leaf == "lambda":
            u = torch.rand(p.shape, generator=gen, device=p.device)
            u = (u * (0.999 - 0.9) + 0.9) ** (1.0 / R._C_RGLRU)
            p.copy_(torch.log(u / (1.0 - u)))
        else:
            p.normal_(generator=gen)
            p.mul_(0.02 if leaf in ("table", "conv_w")
                   else 1.0 / math.sqrt(p.shape[0]))
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

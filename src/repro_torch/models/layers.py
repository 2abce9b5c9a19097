"""Core transformer layers on PyTorch: functional apply, ``repro``'s
layouts.

Conventions (as in ``repro/models/layers.py``):
  * ``params`` is a mapping of named tensors -- an ``nn.ParameterDict`` in
    the port's modules, a plain dict in tests -- with ``repro``'s names.
  * projections are ``x @ w`` with ``w`` stored ``[in, out]``; attention
    takes ``q [B, S, H, dh]`` and ``k, v [B, S, KH, dh]``.
  * norms and the softmax accumulate in float32; outputs take the input's
    dtype.  In a bfloat16 model the activations are bfloat16 and round
    where ``repro``'s do: norms and RoPE compute in float32 and cast back,
    each projection's product is rounded to bfloat16 (the LM head's too,
    before ``.float()``), attention returns q's dtype.  Where ``repro``
    multiplies a bfloat16 activation by a float32 leaf (the MoE router,
    the mLSTM's gate projections), JAX promotes to float32; the port casts
    the activation explicitly, since ``torch.matmul`` refuses mixed
    operands.
  * training attention is chunked online-softmax, streaming over KV
    blocks, so the score tensor is ``[B, Sq, H, chunk]``, never ``[Sq,
    Skv]``.  It runs under autograd, as ``repro`` runs it under
    ``jax.grad`` (the Pallas attention kernels have no backward).
  * serving attention goes through the kernels' dispatches: the prefill
    calls :func:`repro_torch.kernels.flash_attention.flash_attention`
    (:mod:`repro_torch.models.kv_cache`), the decode step
    :func:`decode_attention` below; each runs its Hopper kernel on a CUDA
    tensor and its plain twin on a CPU tensor.

``repro``'s mesh constraint (``maybe_constrain``) and tuning knobs
(``REPRO_DISABLE_OPT``, ``REPRO_ATTN_CHUNK``) belong to its TPU build and
are not ported.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from ..kernels import decode_attention as _decode

Params = Mapping[str, torch.Tensor]

_NEG_INF = -1e30


# --------------------------------------------------------------------- norms
def rmsnorm(x, params: Params, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * params["scale"].float()
    return out.to(dt)


def layernorm(x, params: Params, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    out = out * params["scale"].float() + params["bias"].float()
    return out.to(dt)


def apply_norm(x, params: Params, kind: str):
    return rmsnorm(x, params) if kind == "rmsnorm" else layernorm(x, params)


# ---------------------------------------------------------------------- rope
def rope_angles(positions, head_dim: int, theta: float):
    """positions [*] -> (cos, sin) [*, head_dim/2] in float32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=positions.device), exps)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta: float):
    """x [..., S, H, dh]; positions [..., S] (broadcastable)."""
    dt = x.dtype
    half = x.shape[-1] // 2
    cos, sin = rope_angles(positions, x.shape[-1], theta)   # [..., S, half]
    cos = cos[..., None, :]                                 # [..., S, 1, half]
    sin = sin[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(dt)


# --------------------------------------------------------------- projections
def qkv_project(x, params: Params, n_heads: int, kv_heads: int,
                head_dim: int):
    """x [B,S,D] -> q [B,S,H,dh], k/v [B,S,KH,dh]."""
    B, S, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return (q.reshape(B, S, n_heads, head_dim),
            k.reshape(B, S, kv_heads, head_dim),
            v.reshape(B, S, kv_heads, head_dim))


# ------------------------------------------------- chunked streaming attention
def chunked_attention(q, k, v, *, causal: bool, window: Optional[int] = None,
                      q_offset: int = 0, chunk: int = 1024):
    """Flash-style online-softmax attention, streaming over KV chunks.

    q [B,Sq,H,dh]; k,v [B,Skv,KH,dh] with H % KH == 0 (GQA: query head
    ``h`` reads kv head ``h // (H // KH)``).  ``q_offset`` is the absolute
    position of q[0] relative to k[0]; ``window`` a sliding-window size
    (None = unbounded).  Returns [B,Sq,H,dh] in q's dtype.
    """
    B, Sq, H, dh = q.shape
    _, Skv, KH, _ = k.shape
    G = H // KH
    chunk = min(chunk, Skv)
    n_chunks = (Skv + chunk - 1) // chunk
    pad = n_chunks * chunk - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    qg = q.reshape(B, Sq, KH, G, dh).float()
    scale = 1.0 / math.sqrt(dh)
    q_pos = q_offset + torch.arange(Sq, device=dev)                 # [Sq]
    m = torch.full((B, Sq, KH, G), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, KH, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, KH, G, dh), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        kb = k[:, c * chunk:(c + 1) * chunk].float()
        vb = v[:, c * chunk:(c + 1) * chunk].float()
        kv_pos = c * chunk + torch.arange(chunk, device=dev)        # [chunk]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, kb) * scale
        mask = (kv_pos[None, :] < Skv).expand(Sq, chunk)
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask[None, :, None, None, :], s,
                        torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-20)
    return out.reshape(B, Sq, H, dh).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len: int, *,
                     window: Optional[int] = None):
    """Single-position attention against a cache.  q [B,1,H,dh];
    k_cache/v_cache [B,L,KH,dh]; ``cache_len`` (a host int) valid entries
    from position 0; ``window`` keeps only the last ``window`` of them.
    Returns [B,1,H,dh] in q's dtype."""
    B, _, H, dh = q.shape
    out = _decode.decode_attention(q.reshape(B, H, dh), k_cache, v_cache,
                                   int(cache_len), window=window)
    return out.reshape(B, 1, H, dh)


# ----------------------------------------------------------------------- mlp
def mlp(x, params: Params, act: str):
    if act in ("silu", "swiglu"):
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = F.gelu(x @ params["w_up"], approximate="tanh")   # jax.nn.gelu
    return h @ params["w_down"]


# ---------------------------------------------------------------- embeddings
def embed(tokens, params: Params):
    """Rows of the table.  ``F.embedding``, not indexing: indexing's
    backward on the CPU adds repeated tokens' rows with parallel atomics
    (an order that changes from run to run), embedding's in index order,
    so a training step is bitwise reproducible on both devices."""
    return F.embedding(tokens.long(), params["table"])


def lm_head(x, params: Params):
    return (x @ params["w"]).float()

"""KV cache and recurrent state, and the decode path: prefill that builds
the cache, one-token decode steps against it.

Cache layout (``repro``'s, per block):

  attn          {"k", "v"}: [B, Lc, KH, dh]            Lc = cache_len
  swa/local     {"k", "v"}: [B, min(window, Lc), ...]  ring buffer
  rec           {"conv": [B, W-1, D], "h": [B, D]}     h float32
  mlstm         {"C": [B, H, dh, dh], "n": [B, H, dh], "m": [B, H]}
  slstm         {"c", "n", "h", "m"}: [B, H, dh]       float32, dh = D/H
  xattn         {"xk", "xv"}: [B, Lm, KH, dh]          projected memory
  encdec        self {"k", "v"} + cross {"xk", "xv"}

In a ring, absolute position ``p`` lives in slot ``p % Lc``.  RoPE is
applied at absolute positions before insertion, so ring entries need no
window mask: everything resident is in the window by construction.  A
``rec`` block's entry is its RG-LRU state: the last ``W - 1 = 3`` inputs
of the causal convolution and the scan's last output; an ``mlstm`` or
``slstm`` block's its cell's state (``m`` starts at -1e30 for the mLSTM,
at zero for the sLSTM, as in ``repro``).  The cache is a list with one
entry per block in layer order (the port's blocks are a ``ModuleList``,
not ``repro``'s scanned stack), on the model's device.

The cross-attention entries ``xk``/``xv`` are the memory's keys and
values, projected once in the prefill (or :func:`init_cache`) and only
read by the decode steps.  An encoder-decoder encodes its frames first,
in the prefill, and its decoder blocks cross-attend to the encoder's
output; a model with ``xattn`` blocks reads ``memory`` directly.

The prefill's attention -- causal self attention, the encoder's
non-causal self attention and every cross attention (the prompt's rows
against the Lm memory rows, non-causal) -- is the flash dispatch
(:func:`repro_torch.kernels.flash_attention.flash_attention`), the decode
step's -- self, and cross over the whole memory -- is
:func:`repro_torch.models.layers.decode_attention`, and a ``rec``
block's scan :func:`repro_torch.kernels.rg_lru.rglru_scan` (S steps from
zero in the prefill, one step from the cached ``h`` in the decode); each
runs its Hopper kernel on a CUDA tensor and its twin on a CPU tensor.  An
``mlstm`` block runs its chunkwise form in the prefill and its one-token
step in the decode, an ``slstm`` block its scan (S steps, then one), as
tensor code (:mod:`repro_torch.models.recurrent`).  All run under
``torch.no_grad``.

The K/V entries and a ``rec`` block's ``conv`` take the model's
parameter dtype (``repro`` writes ``k.astype(cache["k"].dtype)``), the
xLSTM states and ``h`` stay float32.

Under a mesh (``launch/serve.py``'s ``run(mesh=)``) a block's
tensor-parallel hooks (``blk.tp``) run attention on the rank's heads and
the RG-LRU on its channels, so its cache entry holds the rank's rows and
``kv_heads / tp`` KV heads, or ``d_model / tp`` channels of ``conv`` and
``h`` (:func:`local_widths`; the layout:
:func:`repro_torch.distributed.sharding.cache_layout`); the decode
kernel's group G = H / KH is unchanged, both counts being divided.
Cross attention's ``xk`` / ``xv`` are projected by the rank's ``wk`` /
``wv`` columns from the whole memory (or the encoder's output, which
every rank of the 'model' slice computes whole).  xLSTM cells run whole
on the rank's rows.

Where ``repro`` returns a new cache from each decode step, the port
writes the step's key and value, or the recurrent block's new state,
into the cache in place (saving a copy of the cache per token) and
returns the same list.  A MoE block routes the tokens of the call it is
in (``transformer._ffn_apply``): the prefill's B*S, a decode step's B
(capacity ``max(8, ...)``, as in ``repro``), so the two may drop
different assignments.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.flash_attention import flash_attention
from . import layers as L
from . import recurrent as R
from .transformer import (_CROSS, Transformer, _check_ported, apply_block,
                          cross_memory, logits_head, reads_memory, xkv)

Cache = List[Dict[str, torch.Tensor]]
_RING = ("swa", "local")
# a recurrent block's cache entry: its state's names, in the state's order
_STATE = {"rec": ("conv", "h"), "mlstm": ("C", "n", "m"),
          "slstm": ("c", "n", "h", "m")}


def _check(params: Transformer, cfg: ArchConfig) -> None:
    _check_ported(cfg)
    if cfg != params.cfg:
        raise ValueError("cfg differs from the model's configuration")


def _cache_len_for(kind: str, cfg: ArchConfig, cache_len: int) -> int:
    if kind in _RING and cfg.window:
        return min(cfg.window, cache_len)
    return cache_len


def local_widths(blk, cfg: ArchConfig):
    """The block's KV heads and RG-LRU channels on this rank: the 'model'
    slice's share where the block's tensor-parallel hooks (``blk.tp``)
    run attention on local heads or the RG-LRU on local channels, else
    the config's."""
    tp = blk.tp
    kv_heads, width = cfg.kv_heads, cfg.d_model
    if tp is not None and tp.plan.attn:
        kv_heads //= tp.size
    if tp is not None and tp.plan.rg:
        width //= tp.size
    return kv_heads, width


@torch.no_grad()
def init_cache(params: Transformer, cfg: ArchConfig, batch: int,
               cache_len: int, dtype=None, *, memory=None,
               enc_frames=None) -> Cache:
    """Zeroed cache, one entry per block (``{"k", "v"}`` in ``dtype``, by
    default the model's parameter dtype, or a recurrent block's state:
    ``rec`` ``{"conv", "h"}``, ``conv`` in ``dtype`` and ``h`` float32,
    ``mlstm`` ``{"C", "n", "m"}`` and ``slstm`` ``{"c", "n", "h", "m"}``
    float32), on the model's device.  A cross-attention block's ``{"xk",
    "xv"}`` are projected from ``memory`` (or from the encoder's output
    over ``enc_frames``), as ``repro`` precomputes them.  A block that
    runs tensor-parallel holds its rank's KV heads or RG-LRU channels
    (:func:`local_widths`).  On the ``meta`` device nothing is computed:
    the encoder's output takes its frames' shape."""
    _check(params, cfg)
    dev = params.device
    if dev.type == "meta" and cfg.encoder is not None:
        if enc_frames is None:
            raise ValueError(f"{cfg.name} encodes enc_frames [B, Le, D]; "
                             "none were given")
        memory, enc_frames = enc_frames, None
        cfg = dataclasses.replace(cfg, encoder=None)
    memory = cross_memory(params, cfg, memory, enc_frames, _encoder_attend)
    dtype = params.dtype if dtype is None else dtype
    H = cfg.n_heads
    out = []
    for blk in params.blocks:
        kind = blk.kind
        kv_heads, width = local_widths(blk, cfg)
        if kind in _STATE:
            if kind == "rec":
                state = R.rglru_init_state(batch, width, dev, dtype=dtype)
            elif kind == "mlstm":
                state = R.mlstm_init_state(batch, H, cfg.d_model // H, dev)
            else:
                state = R.slstm_init_state(batch, H, cfg.d_model // H, dev)
            out.append(dict(zip(_STATE[kind], state)))
            continue
        entry = {}
        if kind != "xattn":
            shape = (batch, _cache_len_for(kind, cfg, cache_len),
                     kv_heads, cfg.dh)
            entry = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                     "v": torch.zeros(shape, dtype=dtype, device=dev)}
        if kind in _CROSS:
            entry["xk"], entry["xv"] = xkv(blk.xattn, memory, cfg)
        out.append(entry)
    return out


def meta_cache(cfg: ArchConfig, batch: int, cache_len: int,
               memory_len: Optional[int] = None,
               dtype=torch.bfloat16) -> Cache:
    """:func:`init_cache` of a ``meta`` model of ``cfg`` in ``dtype``:
    every entry's shape and dtype, nothing drawn or allocated.  A model
    with cross attention reads a memory (an encoder-decoder, frames) of
    ``memory_len`` rows (default ``cfg.cross_memory_len``)."""
    model = Transformer(cfg, device="meta", dtype=dtype)
    rows = cfg.cross_memory_len if memory_len is None else memory_len
    x = torch.empty((batch, rows, cfg.d_model), dtype=dtype, device="meta")
    kw = {}
    if cfg.encoder is not None:
        kw["enc_frames"] = x
    elif reads_memory(cfg):
        kw["memory"] = x
    return init_cache(model, cfg, batch, cache_len, **kw)


def _fit(x, Lc: int, ring: bool):
    """The prefill's keys or values [B, S, KH, dh] as a cache of Lc
    entries: the last Lc positions (a ring rolled so position p sits in
    slot p % Lc), or the S positions padded with zeros."""
    S = x.shape[1]
    if S >= Lc:
        x = x[:, S - Lc:]
        if ring:
            x = torch.roll(x, S % Lc, dims=1)
        return x.contiguous()
    return F.pad(x, (0, 0, 0, 0, 0, Lc - S))


def _prefill_attend(q, k, v, window: Optional[int]):
    return flash_attention(q, k, v, causal=True, window=window)


def _encoder_attend(q, k, v, window: Optional[int]):
    return flash_attention(q, k, v, causal=False, window=window)


def _prefill_xattend(memory, cfg: ArchConfig):
    """The prefill's cross attention: the memory's keys and values
    projected, then flash over all of them (non-causal)."""
    def xattend(q, p_attn):
        k, v = xkv(p_attn, memory, cfg)
        return flash_attention(q, k, v, causal=False), (k, v)
    return xattend


@torch.no_grad()
def forward_with_cache(params: Transformer, tokens, cfg: ArchConfig,
                       cache_len: int, *, memory=None, enc_frames=None):
    """Prefill: the forward pass over ``tokens`` [B, S] that also builds
    the decode cache for ``cache_len`` positions.  A model with cross
    attention reads ``memory`` [B, Lm, D]; an encoder-decoder encodes
    ``enc_frames`` [B, Le, D] first.  Returns ``(logits [B, S, vocab]
    float32, cache)``."""
    _check(params, cfg)
    memory = cross_memory(params, cfg, memory, enc_frames, _encoder_attend)
    xattend = None if memory is None else _prefill_xattend(memory, cfg)
    h = L.embed(tokens, params.embed)
    S = tokens.shape[1]
    pos = torch.arange(S, device=h.device)
    cache = []
    for blk in params.blocks:
        h, state = apply_block(h, blk, blk.kind, cfg, positions=pos,
                               attend=_prefill_attend, xattend=xattend)
        if blk.kind in _STATE:      # copies: the views pin [B, S, D] buffers
            cache.append({n: x.clone(memory_format=torch.contiguous_format)
                          for n, x in zip(_STATE[blk.kind], state)})
            continue
        entry = {}
        if blk.kind != "xattn":
            Lc = _cache_len_for(blk.kind, cfg, cache_len)
            ring = blk.kind in _RING
            entry = {"k": _fit(state[0], Lc, ring),
                     "v": _fit(state[1], Lc, ring)}
        if blk.kind in _CROSS:
            entry.update(xk=state[-2], xv=state[-1])
        cache.append(entry)
    return logits_head(params, h), cache


def _decode_attend(entry: Dict[str, torch.Tensor], pos: int, ring: bool):
    """The decode step's attention for one block: write the token's key and
    value into its slot, then attend over the resident entries."""
    def attend(q, k, v, window):
        Lc = entry["k"].shape[1]
        slot = pos % Lc if ring else min(pos, Lc - 1)
        entry["k"][:, slot] = k[:, 0]
        entry["v"][:, slot] = v[:, 0]
        return L.decode_attention(q, entry["k"], entry["v"],
                                  min(pos + 1, Lc))
    return attend


def _decode_xattend(entry: Dict[str, torch.Tensor]):
    """The decode step's cross attention for one block: the query against
    every row of the cached memory keys and values, which stay as they
    are."""
    def xattend(q, p_attn):
        xk, xv = entry["xk"], entry["xv"]
        return L.decode_attention(q, xk, xv, xk.shape[1]), (xk, xv)
    return xattend


@torch.no_grad()
def decode_step(params: Transformer, token, cache: Cache, pos: int,
                cfg: ArchConfig):
    """One serving step.  ``token`` [B, 1], ``pos`` the token's absolute
    position (a host int: the current length).  Returns ``(logits [B, 1,
    vocab] float32, cache)``, the cache updated in place."""
    _check(params, cfg)
    pos = int(pos)
    h = L.embed(token, params.embed)
    posv = torch.full((1,), pos, device=h.device)
    for blk, entry in zip(params.blocks, cache):
        if blk.kind in _STATE:
            names = _STATE[blk.kind]
            h, state = apply_block(
                h, blk, blk.kind, cfg, positions=posv, attend=None,
                state=tuple(entry[n] for n in names))
            for n, x in zip(names, state):
                entry[n].copy_(x)
            continue
        h, _ = apply_block(h, blk, blk.kind, cfg, positions=posv,
                           attend=_decode_attend(entry, pos,
                                                 blk.kind in _RING),
                           xattend=_decode_xattend(entry))
    return logits_head(params, h), cache

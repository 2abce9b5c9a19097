"""Transformer backbone on PyTorch: the ``attn``/``swa``/``local`` blocks
and the RG-LRU ``rec`` block, each with a dense MLP (the families
``flaas-100m``, the dense GQA configs and ``recurrentgemma-2b`` need);
xLSTM's ``mlstm`` and ``slstm`` blocks (a norm and the cell, no MLP:
``xlstm-125m``); the cross-attention ``xattn`` block, its attention and
MLP each scaled by the tanh of a scalar gate (``llama-3.2-vision-11b``);
and the ``encdec`` decoder block (self attention, cross attention, MLP)
with its encoder, a stack of non-causal ``attn`` blocks over the frames
(``whisper-medium``).  Where the config marks a block ``use_moe`` (the
MoE family, ``mixtral-8x22b`` and ``kimi-k2-1t-a32b``), its MLP is a
mixture of experts (:mod:`repro_torch.models.moe`), plus a shared expert
where the config has one.  Cross attention reads
``memory`` [B, Lm, D] (or the encoder's output): q from the block's
input, k and v projected from the memory, no RoPE, no mask.

``repro`` keeps parameters as a pytree and stacks the repeating body for
``lax.scan``; the port keeps them in an ``nn.Module`` -- a ``ModuleList``
of blocks, in layer order (prefix, body group by group, suffix) -- whose
``nn.ParameterDict``s carry ``repro``'s names (``embed.table``,
``blocks.3.attn.wq``, ``blocks.4.gate_x``, ``blocks.1.moe.w_up``,
``final_norm.scale``, ``lm_head.w``, ``encoder.blocks.0.attn.wq``).
Every parameter is a view into one flat buffer of its dtype: a float32
model has one, ``model.flat``, so DP code can read, write and difference
a whole model as one vector without copying it piecewise.  A bfloat16
model (``dtype=torch.bfloat16``) keeps ``repro``'s float32 leaves float32
-- norm scales and biases, the RG-LRU's ``b_a``, ``b_i`` and ``lambda``,
the mLSTM's ``w_i``, ``b_i``, ``w_f`` and ``b_f``, the sLSTM's ``b_in``
and ``r``, the ``xattn`` gates and the MoE router -- and so holds two,
``model.flats[torch.bfloat16]`` and ``model.flats[torch.float32]``;
:func:`flat_delta` and :func:`add_flat_` read and write such a model as
one float32 vector in parameter order.  The port's default is float32
(``repro``'s is bfloat16): its one-device launchers, like ``repro``'s,
run float32.  The parameters are laid out on the meta device and the
buffers are the allocations, so a model that does not fit its device
fails there, with its size in the message.

``remat`` trades memory for recompute and leaves values unchanged; at the
sizes this slice runs (``flaas-100m``, batch 2 x 256 tokens) the port
keeps every activation and ignores it.

Entry points:

  init_model(cfg, seed, device, dtype)
                                    -> Transformer (random, torch.Generator)
  params_from_jax(tree, cfg, device, dtype)
                                    -> Transformer holding repro's values
  forward(params, tokens, cfg, memory=, enc_frames=)
                                    -> logits [B, S, vocab] (float32)
  encode(params, frames, cfg)       -> the encoder's output [B, Le, D]
  lm_loss(logits, labels, mask)     -> mean token cross-entropy

A block has one code path, :func:`apply_block`, for the training forward,
the prefill and the decode step (:mod:`repro_torch.models.kv_cache`); only
the attention calls (self and cross) and the recurrent state it is given
differ between them.  A ``rec`` block trains on both devices: under
autograd the scan runs its twin's backward on the CPU and the Hopper
backward kernel on the card (:mod:`repro_torch.kernels.rg_lru`).  The
xLSTM blocks are tensor code on either device
(:mod:`repro_torch.models.recurrent`).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..configs.base import ArchConfig
from . import layers as L
from . import moe as M
from . import recurrent as R

_PORTED_KINDS = ("attn", "swa", "local", "rec", "mlstm", "slstm", "xattn",
                 "encdec")
_XLSTM = ("mlstm", "slstm")
_CROSS = ("xattn", "encdec")     # blocks that read the memory


def _check_ported(cfg: ArchConfig) -> None:
    for kind, _ in cfg.layer_specs():
        if kind not in _PORTED_KINDS:
            raise ValueError(f"unknown block kind {kind!r}")


def reads_memory(cfg: ArchConfig) -> bool:
    """Whether the model's blocks cross-attend to a memory (or to its
    encoder's output)."""
    return any(kind in _CROSS for kind, _ in cfg.layer_specs())


# Leaves ``repro`` keeps float32 whatever the parameter dtype, by the
# owner's name in the block: the RG-LRU's gate biases and decay
# (``recurrent.py:46-49``), the mLSTM's gate projections (``:119-122``),
# the sLSTM's gate bias and recurrent weights (``:238-246``), the MoE
# router (``moe.py:40``).  Norms (``layers.py:25, :55``, :func:`_norm`)
# and the ``xattn`` gates (``transformer.py:76-77``) are float32 whole.
_FLOAT32_LEAVES = {"rg": ("b_a", "b_i", "lambda"),
                   "mlstm": ("w_i", "b_i", "w_f", "b_f"),
                   "slstm": ("b_in", "r"), "moe": ("router",)}


def _pdict(shapes: Dict[str, tuple], device, dtype=torch.float32,
           keep32=()) -> nn.ParameterDict:
    """Parameters of ``shapes`` in ``dtype``, those named in ``keep32`` in
    float32."""
    return nn.ParameterDict({
        k: nn.Parameter(torch.empty(
            s, dtype=torch.float32 if k in keep32 else dtype, device=device))
        for k, s in shapes.items()})


def _norm(d: int, kind: str, device) -> nn.ParameterDict:
    """A norm's leaves, float32 in any model."""
    return _pdict(_norm_shapes(d, kind), device)


def _norm_shapes(d: int, kind: str) -> Dict[str, tuple]:
    return {"scale": (d,)} if kind == "rmsnorm" else \
        {"scale": (d,), "bias": (d,)}


def _rg_shapes(D: int) -> Dict[str, tuple]:
    """The RG-LRU's leaves in ``repro``'s order (``init_rglru_block``)."""
    return {"w_x": (D, D), "w_gate_br": (D, D),
            "conv_w": (R.CONV_WIDTH, D), "conv_b": (D,), "w_a": (D, D),
            "b_a": (D,), "w_i": (D, D), "b_i": (D,), "lambda": (D,),
            "w_out": (D, D)}


def _mlp_shapes(cfg: ArchConfig, width: int) -> Dict[str, tuple]:
    """A dense MLP's leaves in ``repro``'s order (``init_mlp``)."""
    D = cfg.d_model
    mlp = {"w_up": (D, width), "w_down": (width, D)}
    if cfg.act in ("silu", "swiglu"):
        mlp["w_gate"] = (D, width)
    return mlp


def _moe_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    """The experts' leaves in ``repro``'s order (``init_moe``)."""
    D, Fw, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    moe = {"router": (D, E), "w_up": (E, D, Fw), "w_down": (E, Fw, D)}
    if cfg.act in ("silu", "swiglu"):
        moe["w_gate"] = (E, D, Fw)
    return moe


def _attn_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    D, H, KH, dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.dh
    attn = {"wq": (D, H * dh), "wk": (D, KH * dh), "wv": (D, KH * dh),
            "wo": (H * dh, D)}
    if cfg.qkv_bias:
        attn.update(bq=(H * dh,), bk=(KH * dh,), bv=(KH * dh,))
    return attn


class Block(nn.Module):
    """One block, its leaves named and ordered as in ``repro``'s
    ``init_block``: ``norm1``, the mixer (``attn`` for ``attn``/``swa``/
    ``local``, ``rg`` for ``rec``), ``norm2``, ``mlp``; for ``mlstm``/
    ``slstm``, ``norm1`` and the ``cell`` alone; for ``xattn``,
    ``normx``, ``xattn``, the scalar gates ``gate_x`` and ``gate_m``,
    ``norm2``, ``mlp``; for ``encdec``, ``norm1``, ``attn``, ``normx``,
    ``xattn``, ``norm2``, ``mlp``.  A ``use_moe`` block holds ``moe``
    (``router``, ``w_up``, ``w_down``, ``w_gate``: the experts at the
    config's ``d_ff``) and, where the config has shared experts,
    ``shared`` (a dense MLP ``n_shared`` times as wide) in place of
    ``mlp``; a dense block of a MoE model (kimi's prefix) keeps ``mlp`` at
    ``dense_ff``.  The gates are the block's own parameters, so they come
    first in its parameter order (and in ``model.flat``): a module lists
    its own parameters before its children's.  ``tp`` holds the block's
    tensor-parallel hooks in a sharded training step
    (:mod:`repro_torch.distributed.tensor_parallel`), None elsewhere."""

    tp = None

    def __init__(self, kind: str, use_moe: bool, cfg: ArchConfig, device,
                 dtype=torch.float32):
        super().__init__()
        self.kind = kind
        self.use_moe = use_moe
        D, H = cfg.d_model, cfg.n_heads
        if kind != "xattn":
            self.norm1 = _norm(D, cfg.norm, device)
        if kind in _XLSTM:
            shapes = R.mlstm_shapes if kind == "mlstm" else R.slstm_shapes
            self.cell = _pdict(shapes(D, H), device, dtype,
                               _FLOAT32_LEAVES[kind])
            return
        if kind == "rec":
            self.rg = _pdict(_rg_shapes(D), device, dtype,
                             _FLOAT32_LEAVES["rg"])
        elif kind != "xattn":
            self.attn = _pdict(_attn_shapes(cfg), device, dtype)
        if kind in _CROSS:
            self.normx = _norm(D, cfg.norm, device)
            self.xattn = _pdict(_attn_shapes(cfg), device, dtype)
        if kind == "xattn":
            for gate in ("gate_x", "gate_m"):
                setattr(self, gate, nn.Parameter(torch.empty(
                    (), dtype=torch.float32, device=device)))
        self.norm2 = _norm(D, cfg.norm, device)
        if not use_moe:
            self.mlp = _pdict(_mlp_shapes(cfg, cfg.dense_ff or cfg.d_ff),
                              device, dtype)
            return
        self.moe = _pdict(_moe_shapes(cfg), device, dtype,
                          _FLOAT32_LEAVES["moe"])
        if cfg.moe.n_shared:
            self.shared = _pdict(
                _mlp_shapes(cfg, cfg.d_ff * cfg.moe.n_shared), device, dtype)

    def forward(self, h, cfg: ArchConfig, positions, causal: bool = True,
                memory=None):
        return apply_block_train(h, self, self.kind, cfg,
                                 positions=positions, causal=causal,
                                 memory=memory)


class Encoder(nn.Module):
    """``whisper-medium``'s encoder: ``blocks`` (``attn`` blocks) and
    ``final_norm``, ``repro``'s ``params["encoder"]``."""

    def __init__(self, cfg: ArchConfig, device, dtype=torch.float32):
        super().__init__()
        self.blocks = nn.ModuleList(
            Block("attn", False, cfg, device, dtype)
            for _ in range(cfg.encoder.n_layers))
        self.final_norm = _norm(cfg.d_model, cfg.norm, device)


# (q, k, v, window) -> attention output [B, S, H, dh]
Attend = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, Optional[int]],
                  torch.Tensor]
# (q [B, S, H, dh], the block's ``xattn`` leaves) -> (attention output
# [B, S, H, dh], the memory's keys and values (xk, xv) [B, Lm, KH, dh])
CrossAttend = Callable[[torch.Tensor, nn.ParameterDict],
                       Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]]


def xkv(p_attn, memory, cfg: ArchConfig):
    """The memory's cross-attention keys and values [B, Lm, KH, dh]
    (``repro``'s ``kv_cache._xkv``, and the k/v of
    ``transformer._xattn_apply``): projected, biased where the config has
    QKV biases, no RoPE."""
    B, Lm = memory.shape[:2]
    k, v = memory @ p_attn["wk"], memory @ p_attn["wv"]
    if "bk" in p_attn:
        k, v = k + p_attn["bk"], v + p_attn["bv"]
    # heads from the width: a tensor-parallel block holds its share
    return (k.reshape(B, Lm, -1, cfg.dh), v.reshape(B, Lm, -1, cfg.dh))


def _cross(h, p: Block, cfg: ArchConfig, xattend: CrossAttend):
    """Cross attention of the pre-norm ``h`` (``normx``) to the memory
    that ``xattend`` holds: q with its bias and no RoPE, the output
    projected by ``wo``.  Returns ``(output [B, S, D], (xk, xv))``."""
    B, S, _ = h.shape
    tp = p.tp if p.tp is not None and p.tp.plan.attn else None
    x = L.apply_norm(h, p.normx, cfg.norm)
    if tp is not None:
        x = tp.enter(x)
    q = x @ p.xattn["wq"]
    if "bq" in p.xattn:
        q = q + p.xattn["bq"]
    out, kv = xattend(q.reshape(B, S, -1, cfg.dh), p.xattn)
    out = out.reshape(B, S, -1) @ p.xattn["wo"]
    return (out if tp is None else tp.leave(out)), kv


def _ffn_apply(h, p: Block, cfg: ArchConfig):
    """The block's MLP (``repro``'s ``_ffn_apply``): the dense MLP, or
    the experts over this call's B*S tokens in ``moe_dispatch_groups``
    groups, each with ``moe_capacity`` of its own tokens' slots per
    expert, plus the shared expert where there is one."""
    if not p.use_moe:
        return _mlp_tp(h, p.mlp, cfg, p.tp, "mlp")
    B, S, D = h.shape
    spec, G = cfg.moe, cfg.moe_dispatch_groups
    cap = M.moe_capacity(B * S // G, spec.top_k, spec.n_experts,
                         spec.capacity_factor)
    out = M.moe_apply(h.reshape(B * S, D), p.moe, top_k=spec.top_k,
                      capacity=cap, act=cfg.act, n_groups=G
                      ).reshape(B, S, D)
    if spec.n_shared:
        out = out + _mlp_tp(h, p.shared, cfg, p.tp, "shared")
    return out


def _mlp_tp(h, params, cfg: ArchConfig, tp, part: str):
    """A dense MLP, on this rank's columns where ``tp`` keeps ``part``
    local (its output summed over the 'model' slice)."""
    if tp is None or not getattr(tp.plan, part):
        return L.mlp(h, params, cfg.act)
    return tp.leave(L.mlp(tp.enter(h), params, cfg.act))


def apply_block(h, p: Block, kind: str, cfg: ArchConfig, *, positions,
                attend: Optional[Attend], state: Optional[tuple] = None,
                xattend: Optional[CrossAttend] = None):
    """One block: the pre-norm mixer, then the pre-norm MLP, each added to
    the residual.  For ``attn``/``swa``/``local`` the mixer is attention on
    the roped projections, ``attend(q, k, v, window)`` (``window`` the
    config's for ``swa``/``local``, None for ``attn``), and the block's
    new state is ``(k, v)``, the roped keys and values [B, S, KH, dh].
    For ``rec`` it is the RG-LRU from ``state`` (the decode state, None at
    a sequence's start), and the new state ``(conv, h)``.  An ``mlstm`` or
    ``slstm`` block is the pre-norm cell alone, added to the residual: the
    mLSTM chunkwise from ``state`` (from zero when None), or its one-token
    decode step where ``state`` is given and S is 1, the new state ``(C,
    n, m)``; the sLSTM's scan from ``state``, the new state ``(c, n, h,
    m)``.  An ``xattn`` block's mixer is cross attention,
    ``xattend(q, p.xattn)``, its output and the MLP's each scaled by the
    tanh of a gate (``gate_x``, ``gate_m``) before they are added; the new
    state is ``(xk, xv)``.  An ``encdec`` block runs self attention as
    ``attn`` does, then cross attention, then the MLP, each pre-norm and
    added; the new state is ``(k, v, xk, xv)``.  Returns ``(h, new
    state)``."""
    if kind == "xattn":   # gate x output in float32, rounded to h's dtype
        out, new = _cross(h, p, cfg, xattend)
        h = h + (torch.tanh(p.gate_x) * out.float()).to(h.dtype)
        ff = _ffn_apply(L.apply_norm(h, p.norm2, cfg.norm), p, cfg)
        return h + (torch.tanh(p.gate_m) * ff.float()).to(h.dtype), new
    x = L.apply_norm(h, p.norm1, cfg.norm)
    if kind == "mlstm":
        if state is not None and x.shape[1] == 1:
            out, new = R.mlstm_decode_step(x, p.cell, cfg.n_heads, state)
        else:
            out, new = R.mlstm_chunkwise(x, p.cell, cfg.n_heads,
                                         chunk=cfg.mlstm_chunk, state=state)
        return h + out, new
    if kind == "slstm":
        out, new = R.slstm_scan(x, p.cell, cfg.n_heads, state)
        return h + out, new
    tp = p.tp
    if kind == "rec":
        out, new = R.rglru_block(x, p.rg, state,
                                 tp=tp if tp is not None and tp.plan.rg
                                 else None)
    else:
        window = cfg.window if kind in ("swa", "local") else None
        heads, kv_heads = cfg.n_heads, cfg.kv_heads
        local = tp is not None and tp.plan.attn
        if local:                   # this rank's heads
            x = tp.enter(x)
            heads, kv_heads = heads // tp.size, kv_heads // tp.size
        q, k, v = L.qkv_project(x, p.attn, heads, kv_heads, cfg.dh)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        B, S = h.shape[:2]
        out = attend(q, k, v, window).reshape(B, S, -1) @ p.attn["wo"]
        if local:
            out = tp.leave(out)
        new = (k, v)
    h = h + out
    if kind == "encdec":
        out, cross_kv = _cross(h, p, cfg, xattend)
        h = h + out
        new = (*new, *cross_kv)
    return h + _ffn_apply(L.apply_norm(h, p.norm2, cfg.norm), p, cfg), new


def _train_xattend(memory, cfg: ArchConfig) -> CrossAttend:
    """Cross attention to ``memory`` [B, Lm, D] for the training forward:
    :func:`repro_torch.models.layers.chunked_attention`, non-causal
    (autograd)."""
    def xattend(q, p_attn):
        k, v = xkv(p_attn, memory, cfg)
        return L.chunked_attention(q, k, v, causal=False), (k, v)
    return xattend


def apply_block_train(h, p: Block, kind: str, cfg: ArchConfig, *,
                      positions, causal: bool = True, memory=None):
    """The training block: :func:`apply_block` with
    :func:`repro_torch.models.layers.chunked_attention` (autograd) for
    self and cross attention (to ``memory``), a recurrent block from a
    zero state."""
    if memory is not None and p.tp is not None and p.tp.plan.attn:
        memory = p.tp.enter(memory)    # into the local k / v projections
    return apply_block(
        h, p, kind, cfg, positions=positions,
        attend=lambda q, k, v, window: L.chunked_attention(
            q, k, v, causal=causal, window=window),
        xattend=None if memory is None else _train_xattend(memory, cfg))[0]


def encode(params: "Transformer", frames, cfg: ArchConfig,
           attend: Optional[Attend] = None):
    """The encoder over the frame embeddings [B, Le, D] (``repro``'s
    ``encode``): its ``attn`` blocks, non-causal and roped at positions
    0..Le-1, then its final norm.  ``attend`` (default: the training
    forward's non-causal ``chunked_attention``) runs each block's
    attention."""
    if attend is None:
        def attend(q, k, v, window):
            return L.chunked_attention(q, k, v, causal=False, window=window)
    enc = params.encoder
    h = frames
    pos = torch.arange(frames.shape[1], device=frames.device)
    for blk in enc.blocks:
        h = apply_block(h, blk, "attn", cfg, positions=pos, attend=attend)[0]
    return L.apply_norm(h, enc.final_norm, cfg.norm)


def cross_memory(params: "Transformer", cfg: ArchConfig, memory, enc_frames,
                 attend: Optional[Attend] = None):
    """What the cross-attention blocks read: the encoder's output over
    ``enc_frames`` for an encoder-decoder, else ``memory``; None for a
    model without cross attention.  Raises if the model needs an input
    that was not given."""
    if cfg.encoder is not None:
        if enc_frames is None:
            raise ValueError(f"{cfg.name} encodes enc_frames [B, Le, D]; "
                             "none were given")
        return encode(params, enc_frames, cfg, attend)
    if reads_memory(cfg) and memory is None:
        raise ValueError(f"{cfg.name} cross-attends to memory [B, Lm, D]; "
                         "none was given")
    return memory


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
    :func:`params_from_jax` fill them) and its training forward.
    ``dtype`` is the parameter dtype, float32 (the default) or bfloat16;
    in a bfloat16 model ``repro``'s float32 leaves stay float32 (module
    docstring), each dtype in its own flat buffer, ``flats[dtype]``."""

    def __init__(self, cfg: ArchConfig, device="cuda", dtype=torch.float32,
                 shape_of: Optional[Callable[[str, tuple], tuple]] = None):
        super().__init__()
        _check_ported(cfg)
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"parameter dtype {dtype}: float32 or bfloat16")
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        meta = torch.device("meta")     # shapes only: flats are the storage
        self.embed = _pdict({"table": (cfg.vocab, cfg.d_model)}, meta, dtype)
        self.blocks = nn.ModuleList(
            Block(kind, use_moe, cfg, meta, dtype)
            for kind, use_moe in cfg.layer_specs())
        self.final_norm = _norm(cfg.d_model, cfg.norm, meta)
        if not cfg.tie_embeddings:
            self.lm_head = _pdict({"w": (cfg.d_model, cfg.vocab)}, meta, dtype)
        if cfg.encoder is not None:
            self.encoder = Encoder(cfg, meta, dtype)
        # every parameter becomes a view of its slice of its dtype's buffer
        # (of its shard's shape, ``shape_of(name, full shape)``, under a
        # mesh: :mod:`repro_torch.distributed`)
        self.full_shapes = {n: tuple(p.shape)
                            for n, p in self.named_parameters()}
        params = [(n, p.dtype, self.full_shapes[n] if shape_of is None
                   else tuple(shape_of(n, self.full_shapes[n])))
                  for n, p in self.named_parameters()]
        sizes: Dict[torch.dtype, int] = {}
        for _, dt, shape in params:
            sizes[dt] = sizes.get(dt, 0) + math.prod(shape)
        self.flats: Dict[torch.dtype, torch.Tensor] = {}
        for dt in sorted(sizes, key=lambda d: d != dtype):  # dtype first
            n = sizes[dt]
            try:
                self.flats[dt] = torch.empty(n, dtype=dt, device=dev)
            except RuntimeError as e:       # torch.OutOfMemoryError too
                gb = sum(k * d.itemsize for d, k in sizes.items()) / 1e9
                raise MemoryError(
                    f"{cfg.name} ({cfg.n_layers} layers, d_model "
                    f"{cfg.d_model}): its flat {dt} buffer [{n}] (the model "
                    f"{gb:.1f} GB in all) does not fit on {dev}: {e}") from e
        offs = dict.fromkeys(sizes, 0)
        for name, dt, shape in params:
            owner, _, leaf = name.rpartition(".")
            owner = self.get_submodule(owner)
            off, n = offs[dt], math.prod(shape)
            view = nn.Parameter(self.flats[dt][off:off + n].view(shape))
            if isinstance(owner, nn.ParameterDict):
                owner[leaf] = view
            else:
                setattr(owner, leaf, view)
            offs[dt] += n

    @property
    def flat(self) -> torch.Tensor:
        """The one flat buffer of a float32 model.  A bfloat16 model has
        one per dtype (``flats``); :func:`flat_delta` and
        :func:`add_flat_` read and write it as one vector."""
        if len(self.flats) != 1:
            raise ValueError(
                f"a {self.dtype} model keeps one flat buffer per dtype "
                f"({sorted(str(d) for d in self.flats)}): use model.flats, "
                "flat_delta or add_flat_")
        return next(iter(self.flats.values()))

    @property
    def device(self) -> torch.device:
        return next(iter(self.flats.values())).device

    @property
    def n_params(self) -> int:
        return sum(f.numel() for f in self.flats.values())

    def forward(self, tokens, memory=None, enc_frames=None):
        return forward_with(self, tokens, self.cfg, memory=memory,
                            enc_frames=enc_frames)


def forward_with(params: Transformer, tokens, cfg: ArchConfig, *,
                 memory=None, enc_frames=None):
    """The training forward of ``params`` under ``cfg``, the model's own
    configuration or one that differs from it only in how the step runs
    it (a sharded step's MoE dispatch groups over its rows)."""
    memory = cross_memory(params, cfg, memory, enc_frames)
    h = L.embed(tokens, params.embed)
    pos = torch.arange(tokens.shape[1], device=h.device)
    for blk in params.blocks:
        h = blk(h, cfg, pos, memory=memory)
    return logits_head(params, h)


def clone_model(model: Transformer) -> Transformer:
    """A new model of the same configuration, dtype and device holding a
    copy of ``model``'s values."""
    out = Transformer(model.cfg, device=model.device, dtype=model.dtype)
    with torch.no_grad():
        for dt, buf in out.flats.items():
            buf.copy_(model.flats[dt])
    return out


def unflatten(model: Transformer, vec: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
    """Views of a flat ``[P]`` vector as ``{name: tensor}``, laid out as
    ``model``'s parameters (in parameter order, whatever their dtypes)."""
    out, off = {}, 0
    for name, p in model.named_parameters():
        out[name] = vec[off:off + p.numel()].view(p.shape)
        off += p.numel()
    return out


def flat_delta(new: Transformer, old: Transformer,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``new - old`` as one float32 ``[P]`` vector in parameter order
    (written into ``out`` when given): each leaf cast exactly to float32
    and subtracted, as ``repro``'s ``fedavg.client_update``.  For a
    float32 model, one subtraction of the flat buffers."""
    if new.dtype == torch.float32:
        return torch.sub(new.flat, old.flat, out=out)
    if out is None:
        out = torch.empty(new.n_params, dtype=torch.float32,
                          device=new.device)
    views = unflatten(new, out)
    for (name, a), b in zip(new.named_parameters(), old.parameters()):
        torch.sub(a.detach().float(), b.detach().float(), out=views[name])
    return out


@torch.no_grad()
def add_flat_(model: Transformer, vec: torch.Tensor) -> None:
    """``model += vec`` in place, ``vec`` a float32 ``[P]`` vector in
    parameter order: each leaf added in float32 and rounded once to its
    dtype (``repro``'s ``(p.astype(f32) + d).astype(p.dtype)``).  For a
    float32 model, one addition to the flat buffer."""
    if model.dtype == torch.float32:
        model.flat.add_(vec)
        return
    for p, d in zip(model.parameters(), unflatten(model, vec).values()):
        p.copy_(p.float() + d)


@torch.no_grad()
def init_model(cfg: ArchConfig, seed: int = 0, device="cuda",
               dtype=torch.float32,
               shape_of: Optional[Callable[[str, tuple], tuple]] = None,
               cut: Optional[Callable[[str, torch.Tensor], torch.Tensor]]
               = None) -> Transformer:
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device``, with ``repro``'s scheme: dense weights
    ``N(0, 1/fan_in)``, embeddings and the RG-LRU's ``conv_w`` ``N(0,
    0.02^2)``, norm scales one, biases and the ``xattn`` gates zero (a
    cross-attention block starts as the identity), and the RG-LRU's
    ``lambda`` griffin's: ``log(u^(1/8) / (1 - u^(1/8)))`` for ``u ~
    U(0.9, 0.999)``, so that ``sigmoid(lambda)^8`` lies in (0.9, 0.999);
    the mLSTM's forget bias ``b_f`` three (open forget gates), the sLSTM's
    recurrent ``r`` [H, dh, 4 dh] ``0.3 N(0, 1/H)`` and the experts'
    banks [E, D, F] / [E, F, D] ``N(0, 1/E)`` (``repro`` takes the
    leading axis as the fan-in).  (``repro`` draws from ``jax.random``;
    the values differ, the distribution does not.)  ``dtype`` is the
    parameter dtype (:class:`Transformer`; the port's default float32,
    ``repro``'s bfloat16): a bfloat16 leaf is drawn and scaled in float32
    and rounded once, as ``repro`` draws, so it holds the float32 model's
    value of the same seed, rounded.

    With ``shape_of`` (a rank's shape of each leaf, as
    :class:`Transformer` takes it) the model holds a rank's shards: each
    leaf is drawn at its full shape, one leaf at a time in the same
    order, and ``cut(name, full)`` keeps this rank's part, so a shard
    holds the full model's values bitwise without the full model."""
    model = Transformer(cfg, device=device, dtype=dtype, shape_of=shape_of)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        shape = model.full_shapes[name]
        whole = tuple(p.shape) == shape
        if leaf == "scale":
            p.fill_(1.0)
        elif leaf in ("bias", "bq", "bk", "bv", "conv_b", "b_a", "b_i",
                      "b_in", "gate_x", "gate_m"):
            p.zero_()
        elif leaf == "b_f":
            p.fill_(3.0)
        elif leaf == "lambda":
            u = torch.rand(shape, generator=gen, device=p.device)
            u = (u * (0.999 - 0.9) + 0.9) ** (1.0 / R._C_RGLRU)
            w = torch.log(u / (1.0 - u))
            p.copy_(w if whole else cut(name, w))
        else:
            w = p if p.dtype == torch.float32 and whole else torch.empty(
                shape, dtype=torch.float32, device=p.device)
            w.normal_(generator=gen)
            w.mul_(0.02 if leaf in ("table", "conv_w")
                   else 1.0 / math.sqrt(shape[0]))
            if leaf == "r":
                w.mul_(0.3)
            if w is not p:
                p.copy_(w if whole else cut(name, w))
    return model


def _to_tensor(a) -> torch.Tensor:
    """A numpy leaf as a tensor; ``repro``'s bfloat16 leaves (numpy arrays
    whose ``dtype.name`` is ``"bfloat16"``, from ``ml_dtypes``, which the
    port does not import) through their 16-bit pattern, bitwise."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, dtype=np.float32))


@torch.no_grad()
def params_from_jax(tree: Dict[str, Any], cfg: ArchConfig,
                    device="cuda", dtype=torch.float32) -> Transformer:
    """A model of parameter dtype ``dtype`` holding the values of
    ``repro``'s parameter pytree (numpy arrays, e.g. from
    ``jax.device_get(init_model(...))``, float32 or bfloat16 leaves):
    ``prefix`` blocks, then the stacked ``body`` (``[n_groups, ...]`` per
    pattern position, the ``xattn`` gates ``[n_groups]``) group by group,
    then ``suffix``; the stacked ``encoder.body`` block by block.  Every
    leaf of the model must be in the tree.  A leaf is copied into its
    parameter's dtype: bfloat16 into bfloat16 bitwise, bfloat16 into
    float32 exactly."""
    model = Transformer(cfg, device=device, dtype=dtype)

    def unstack(stack, g):
        return {k: unstack(x, g) if isinstance(x, dict) else np.asarray(x)[g]
                for k, x in stack.items()}

    P = len(cfg.pattern)
    blocks = list(tree["prefix"])
    for g in range(cfg.n_groups):
        blocks += [unstack(tree["body"][pos], g) for pos in range(P)]
    blocks += list(tree["suffix"])
    src = {"embed": tree["embed"], "final_norm": tree["final_norm"],
           "blocks": blocks}
    if not cfg.tie_embeddings:
        src["lm_head"] = tree["lm_head"]
    if cfg.encoder is not None:
        enc = tree["encoder"]
        src["encoder"] = {
            "blocks": [unstack(enc["body"], i)
                       for i in range(cfg.encoder.n_layers)],
            "final_norm": enc["final_norm"]}
    for name, p in model.named_parameters():
        a = src
        for key in name.split("."):
            a = a[int(key)] if key.isdigit() else a[key]
        t = _to_tensor(a)
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(p.shape)}")
        p.copy_(t)
    return model


def forward(params: Transformer, tokens, cfg: Optional[ArchConfig] = None,
            *, memory=None, enc_frames=None):
    """Training forward -> logits [B, S, vocab] (float32).  ``cfg``, where
    given, must be the model's own.  A model with cross attention reads
    ``memory`` [B, Lm, D], an encoder-decoder encodes ``enc_frames`` [B,
    Le, D] first (``repro``'s keyword arguments)."""
    if cfg is not None and cfg != params.cfg:
        raise ValueError("cfg differs from the model's configuration")
    return params(tokens, memory=memory, enc_frames=enc_frames)


def lm_loss_parts(logits, labels, mask=None):
    """:func:`lm_loss`'s numerator and denominator: the masked sum of
    token cross-entropies and the mask's sum (a batch split across ranks
    divides the sum of its parts' numerators by the sum of their
    denominators)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    return torch.sum(nll * mask), torch.sum(mask)


def lm_loss(logits, labels, mask=None):
    """Mean token cross-entropy; logits float32 [B,S,V], labels [B,S]."""
    s, n = lm_loss_parts(logits, labels, mask)
    return s / torch.clamp(n, min=1.0)

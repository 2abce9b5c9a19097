"""Recurrent blocks on PyTorch (``repro/models/recurrent.py``): the RG-LRU
of RecurrentGemma / Griffin, and xLSTM's mLSTM and sLSTM blocks.

``repro`` runs the recurrence h_t = a_t h_{t-1} + b_t as a log-depth
``jax.lax.associative_scan`` for the prefill and as one step for the
decode; the port runs both through one sequential scan, the Hopper kernel
``csrc/rg_lru.cu`` on a CUDA tensor and its twin on a CPU tensor
(:func:`repro_torch.kernels.rg_lru.rglru_scan`).  Both compute the same
function; they differ only in rounding (the associative scan's by up to
about 1e-6 of the largest |h|), so the block is held to ``repro`` in
absolute terms scaled by its largest value.

State of a block (``repro``'s decode state): ``(conv [B, W-1, D], h [B,
D])``, the last ``W - 1 = 3`` inputs of the causal convolution, in the
parameters' dtype, and the scan's last output, float32.  The scan's
``a`` and ``b`` are float32 whatever the parameter dtype (``repro``'s
``_rglru_coeffs`` casts before the scan), so the scan kernel and its
backward take float32 only.

The xLSTM blocks are ``repro``'s ``jnp`` code written in PyTorch tensor
operations, in its operation order; ``repro`` has no Pallas kernel for
either, and neither has the port.  The mLSTM runs chunkwise-parallel
(quadratic inside a chunk, a ``[dh, dh]`` state carried across chunks,
stabilised by a running max, all float32) for the prefill and training,
and one O(dh^2) step per token for the decode; the sLSTM is a host loop
over the sequence (its hidden-to-gate recurrence is not associative), as
``repro``'s ``lax.scan``.  States (float32): mLSTM ``(C [B, H, dh, dh],
n [B, H, dh], m [B, H])``, sLSTM ``(c, n, h, m)``, each ``[B, H, dh]``,
with ``dh = D / H``.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import rg_lru

Params = Mapping[str, torch.Tensor]
State = Tuple[torch.Tensor, torch.Tensor]

_C_RGLRU = 8.0
CONV_WIDTH = 4


def _rglru_coeffs(x, params: Params, x_all=None):
    """x [B, S, D] -> decay a and input b (float32).  ``x_all``, where
    given, is every channel of x, which the gate projections read (a
    tensor-parallel block holds only its channels in x)."""
    xg = x if x_all is None else x_all
    r = torch.sigmoid((xg @ params["w_a"]).float() + params["b_a"])
    i = torch.sigmoid((xg @ params["w_i"]).float() + params["b_i"])
    log_a = -_C_RGLRU * F.softplus(params["lambda"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i * x.float()
    return a, b


def linear_scan(a, b, h0: Optional[torch.Tensor] = None):
    """h_t = a_t h_{t-1} + b_t over axis 1 (time).  a, b [B, S, D]
    float32; h0 [B, D] the state before t = 0 (zeros when None)."""
    return rg_lru.rglru_scan(a, b, h0)


def causal_conv1d(x, w, b, state: Optional[torch.Tensor] = None):
    """Depthwise causal convolution.  x [B, S, D], w [W, D], b [D]; state
    [B, W-1, D] the inputs before x (zeros when None).  Taps are summed in
    index order, then the bias added.  Returns (y, new_state), the new
    state the last W - 1 inputs."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                      # [B, S+W-1, D]
    S = x.shape[1]
    y = xp[:, 0:S] * w[0]
    for i in range(1, W):
        y = y + xp[:, i:i + S] * w[i]
    return y + b, xp[:, -(W - 1):]


def rglru_block(x, params: Params, state: Optional[State] = None, tp=None):
    """Griffin's recurrent core.  x [B, S, D] -> (out [B, S, D],
    (conv [B, W-1, D], h [B, D])); ``state`` is the decode state, None for
    a sequence from its start.  ``tp`` (a sharded step's or serve's block
    hooks, :mod:`repro_torch.distributed.tensor_parallel`) runs the block
    on this rank's D / tp channels, the scan included (S steps in the
    prefill, one from the cached ``h`` in a decode step), and sums its
    output over the 'model' slice; the state is then the rank's
    channels', ``(conv [B, W-1, D / tp], h [B, D / tp])``."""
    if tp is not None:
        x = tp.enter(x)
    gate = F.gelu(x @ params["w_gate_br"], approximate="tanh")  # jax.nn.gelu
    xr = x @ params["w_x"]
    conv_state = None if state is None else state[0]
    xr, new_conv = causal_conv1d(xr, params["conv_w"], params["conv_b"],
                                 conv_state)
    a, bcoef = _rglru_coeffs(xr, params,
                             None if tp is None else tp.gather_last(xr))
    h0 = None if state is None else state[1]
    h = linear_scan(a, bcoef, h0)                        # [B, S, D] float32
    out = (h.to(x.dtype) * gate) @ params["w_out"]
    if tp is not None:
        out = tp.leave(out)
    return out, (new_conv, h[:, -1])


def rglru_init_state(batch: int, d_rnn: int, device,
                     conv_width: int = CONV_WIDTH,
                     dtype=torch.float32) -> State:
    """Zeroed decode state of ``d_rnn`` channels (a tensor-parallel
    block's share: ``d_model / tp``) on ``device``: the convolution's
    inputs in ``dtype`` (the parameters'), ``h`` in float32 (``repro``'s
    ``kv_cache.init_cache_slot``)."""
    return (torch.zeros((batch, conv_width - 1, d_rnn), dtype=dtype,
                        device=device),
            torch.zeros((batch, d_rnn), dtype=torch.float32, device=device))


# -------------------------------------------------------------------- mLSTM
MState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
SState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def mlstm_shapes(d_model: int, n_heads: int):
    """The mLSTM's leaves in ``repro``'s order (``init_mlstm_block``)."""
    hd = n_heads * (d_model // n_heads)
    return {"wq": (d_model, hd), "wk": (d_model, hd), "wv": (d_model, hd),
            "w_i": (d_model, n_heads), "b_i": (n_heads,),
            "w_f": (d_model, n_heads), "b_f": (n_heads,),
            "w_o": (d_model, hd), "w_out": (hd, d_model)}


def mlstm_init_state(batch: int, n_heads: int, dh: int, device) -> MState:
    """Zeroed decode state on ``device``: ``C``, ``n`` zero and the
    stabiliser ``m`` at -1e30."""
    return (torch.zeros((batch, n_heads, dh, dh), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, n_heads, dh), dtype=torch.float32,
                        device=device),
            torch.full((batch, n_heads), -1e30, dtype=torch.float32,
                       device=device))


def _mlstm_qkvif(x, params: Params, n_heads: int):
    B, S, D = x.shape
    dh = params["wq"].shape[1] // n_heads
    q = (x @ params["wq"]).reshape(B, S, n_heads, dh)
    k = (x @ params["wk"]).reshape(B, S, n_heads, dh) / math.sqrt(dh)
    v = (x @ params["wv"]).reshape(B, S, n_heads, dh)
    i = (x.float() @ params["w_i"]) + params["b_i"]          # [B, S, H]
    f = (x.float() @ params["w_f"]) + params["b_f"]
    o = torch.sigmoid(x @ params["w_o"]).reshape(B, S, n_heads, dh)
    return q, k, v, i, f, o


def _mlstm_chunk(carry: MState, qb, kb, vb, ib, fb, ob):
    """One chunk of :func:`mlstm_chunkwise`: the chunk's outputs [B, L, H,
    dh] from the carried state, and the state at the chunk's end."""
    C, n, m = carry                  # C [B,H,dh,dh], n [B,H,dh], m [B,H]
    L = qb.shape[1]
    logf = F.logsigmoid(fb)                                  # [B, L, H]
    fcum = torch.cumsum(logf, dim=1)                         # F_t
    ftot = fcum[:, -1]                                       # [B, H]
    # intra-chunk logits A[t, s] = F_t - F_s + i_s  (s <= t)
    A = fcum[:, :, None, :] - fcum[:, None, :, :] + ib[:, None, :, :]
    tril = torch.tril(torch.ones((L, L), dtype=torch.bool, device=A.device))
    A = A.masked_fill(~tril[None, :, :, None], -math.inf)    # [B, t, s, H]
    rowmax = torch.amax(A, dim=2)                            # [B, L, H]
    inter_log = fcum + m[:, None, :]                         # [B, L, H]
    m_t = torch.maximum(rowmax, inter_log)                   # [B, L, H]
    qf, kf, vf = qb.float(), kb.float(), vb.float()
    intra_w = torch.exp(A - m_t[:, :, None, :])              # [B, t, s, H]
    scores = torch.einsum("bthd,bshd->btsh", qf, kf) * intra_w
    num = torch.einsum("btsh,bshd->bthd", scores, vf)
    inter = torch.exp(inter_log - m_t)[..., None]
    num = num + inter * torch.einsum("bthd,bhde->bthe", qf, C)
    den = torch.einsum("btsh,bshd->bthd", intra_w, kf)
    den = den + inter * n[:, None, :, :]
    qn = torch.abs(torch.einsum("bthd,bthd->bth", qf, den))
    denom = torch.maximum(qn, torch.exp(-m_t))
    h = ob.float() * (num / denom[..., None])
    # the state at the chunk's end
    m_next = torch.maximum(m + ftot, torch.amax(
        ftot[:, None, :] - fcum + ib, dim=1))
    w_old = torch.exp(m + ftot - m_next)                     # [B, H]
    w_in = torch.exp(ftot[:, None, :] - fcum + ib - m_next[:, None, :])
    C_next = w_old[..., None, None] * C + \
        torch.einsum("bsh,bshd,bshe->bhde", w_in, kf, vf)
    n_next = w_old[..., None] * n + torch.einsum("bsh,bshd->bhd", w_in, kf)
    return (C_next, n_next, m_next), h


def mlstm_chunkwise(x, params: Params, n_heads: int, chunk: int = 256,
                    state: Optional[MState] = None):
    """Chunkwise-parallel mLSTM.  x [B, S, D] -> (out [B, S, D], final
    state); ``state`` the state before x (:func:`mlstm_init_state` when
    None).  S is padded to a multiple of the chunk with steps whose input
    gate is -1e30 and forget gate 1e3 (log-sigmoid 0), so the state
    passes them untouched; their outputs are cut off."""
    B, S, D = x.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    q, k, v, i, f, o = _mlstm_qkvif(x, params, n_heads)
    if pad:
        q, k, v, o = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v, o))
        i = F.pad(i, (0, 0, 0, pad), value=-1e30)
        f = F.pad(f, (0, 0, 0, pad), value=1e3)
    dh = q.shape[-1]
    n_ch = (S + pad) // chunk
    if state is None:
        state = mlstm_init_state(B, n_heads, dh, x.device)
    hs = []
    for c in range(n_ch):
        sl = slice(c * chunk, (c + 1) * chunk)
        state, h = _mlstm_chunk(state, q[:, sl], k[:, sl], v[:, sl],
                                i[:, sl], f[:, sl], o[:, sl])
        hs.append(h)
    h = torch.cat(hs, dim=1).reshape(B, S + pad, n_heads * dh)[:, :S]
    return h.to(x.dtype) @ params["w_out"], state


def mlstm_decode_step(x, params: Params, n_heads: int, state: MState):
    """One token, x [B, 1, D], from ``state``: O(dh^2) per head.  Returns
    (out [B, 1, D], new state)."""
    B = x.shape[0]
    q, k, v, i, f, o = _mlstm_qkvif(x, params, n_heads)
    dh = q.shape[-1]
    C, n, m = state
    logf = F.logsigmoid(f[:, 0])                             # [B, H]
    m_new = torch.maximum(logf + m, i[:, 0])
    a = torch.exp(logf + m - m_new)
    b = torch.exp(i[:, 0] - m_new)
    kf = k[:, 0].float()
    vf = v[:, 0].float()
    C = a[..., None, None] * C + \
        b[..., None, None] * kf[..., :, None] * vf[..., None, :]
    n = a[..., None] * n + b[..., None] * kf
    qf = q[:, 0].float()
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    qn = torch.abs(torch.einsum("bhd,bhd->bh", qf, n))
    h = num / torch.maximum(qn, torch.exp(-m_new))[..., None]
    h = o[:, 0].float() * h
    out = h.reshape(B, 1, n_heads * dh).to(x.dtype) @ params["w_out"]
    return out, (C, n, m_new)


# -------------------------------------------------------------------- sLSTM
def slstm_shapes(d_model: int, n_heads: int):
    """The sLSTM's leaves in ``repro``'s order (``init_slstm_block``): the
    fused input projection of the gates (i, f, z, o), the block-diagonal
    recurrent weights per head, the output projection."""
    dh = d_model // n_heads
    return {"w_in": (d_model, 4 * d_model), "b_in": (4 * d_model,),
            "r": (n_heads, dh, 4 * dh), "w_out": (d_model, d_model)}


def slstm_init_state(batch: int, n_heads: int, dh: int, device) -> SState:
    """Zeroed decode state ``(c, n, h, m)`` on ``device``."""
    return tuple(torch.zeros((batch, n_heads, dh), dtype=torch.float32,
                             device=device) for _ in range(4))


def slstm_scan(x, params: Params, n_heads: int,
               state: Optional[SState] = None):
    """The sLSTM over x [B, S, D], one step at a time from ``state``
    (zeros when None).  Returns (out [B, S, D], final state)."""
    B, S, D = x.shape
    dh = D // n_heads
    pre_all = (x @ params["w_in"]).float() + params["b_in"]  # [B, S, 4D]
    pre_all = pre_all.reshape(B, S, 4, n_heads, dh)
    if state is None:
        state = slstm_init_state(B, n_heads, dh, x.device)
    c, n, h, m = state
    r = params["r"]
    hs = []
    for t in range(S):
        pre = pre_all[:, t]                                  # [B, 4, H, dh]
        rec = torch.einsum("bhd,hde->bhe", h, r).reshape(B, n_heads, 4, dh)
        it = pre[:, 0] + rec[:, :, 0]
        ft = pre[:, 1] + rec[:, :, 1]
        zt = torch.tanh(pre[:, 2] + rec[:, :, 2])
        ot = torch.sigmoid(pre[:, 3] + rec[:, :, 3])
        logf = F.logsigmoid(ft)
        m_new = torch.maximum(logf + m, it)
        fp = torch.exp(logf + m - m_new)
        ip = torch.exp(it - m_new)
        c = fp * c + ip * zt
        n = fp * n + ip
        h = ot * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
    out = torch.stack(hs, dim=1).reshape(B, S, D).to(x.dtype)
    return out @ params["w_out"], (c, n, h, m)

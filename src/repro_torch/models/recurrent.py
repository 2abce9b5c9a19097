"""Recurrent blocks on PyTorch: the RG-LRU of RecurrentGemma / Griffin
(``repro/models/recurrent.py``, the RG-LRU part; mLSTM and sLSTM are not
ported yet).

``repro`` runs the recurrence h_t = a_t h_{t-1} + b_t as a log-depth
``jax.lax.associative_scan`` for the prefill and as one step for the
decode; the port runs both through one sequential scan, the Hopper kernel
``csrc/rg_lru.cu`` on a CUDA tensor and its twin on a CPU tensor
(:func:`repro_torch.kernels.rg_lru.rglru_scan`).  Both compute the same
function; they differ only in rounding (the associative scan's by up to
about 1e-6 of the largest |h|), so the block is held to ``repro`` in
absolute terms scaled by its largest value.

State of a block (``repro``'s decode state, float32 here): ``(conv [B,
W-1, D], h [B, D])``, the last ``W - 1 = 3`` inputs of the causal
convolution and the scan's last output.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import rg_lru

Params = Mapping[str, torch.Tensor]
State = Tuple[torch.Tensor, torch.Tensor]

_C_RGLRU = 8.0
CONV_WIDTH = 4


def _rglru_coeffs(x, params: Params):
    """x [B, S, D] -> decay a and input b (float32)."""
    r = torch.sigmoid((x @ params["w_a"]).float() + params["b_a"])
    i = torch.sigmoid((x @ params["w_i"]).float() + params["b_i"])
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


def rglru_block(x, params: Params, state: Optional[State] = None):
    """Griffin's recurrent core.  x [B, S, D] -> (out [B, S, D],
    (conv [B, W-1, D], h [B, D])); ``state`` is the decode state, None for
    a sequence from its start."""
    gate = F.gelu(x @ params["w_gate_br"], approximate="tanh")  # jax.nn.gelu
    xr = x @ params["w_x"]
    conv_state = None if state is None else state[0]
    xr, new_conv = causal_conv1d(xr, params["conv_w"], params["conv_b"],
                                 conv_state)
    a, bcoef = _rglru_coeffs(xr, params)
    h0 = None if state is None else state[1]
    h = linear_scan(a, bcoef, h0)                        # [B, S, D] float32
    out = (h.to(x.dtype) * gate) @ params["w_out"]
    return out, (new_conv, h[:, -1])


def rglru_init_state(batch: int, d_rnn: int, device,
                     conv_width: int = CONV_WIDTH) -> State:
    """Zeroed decode state (float32) on ``device``."""
    return (torch.zeros((batch, conv_width - 1, d_rnn), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, d_rnn), dtype=torch.float32, device=device))

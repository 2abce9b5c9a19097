"""Optimizers on ``{name: tensor}`` trees: AdamW, Adafactor and SGD.

Functional, as in ``repro``: ``init(params) -> state`` and
``update(grads, state, params) -> (new_params, new_state)``, with no
tensor changed in place.  ``params`` is a tree or a model (its
``named_parameters()``).  Mixed precision: for low-precision (bfloat16)
parameters AdamW and Adafactor keep a float32 master copy
(``keep_master``, ``repro``'s ``optimizer.py:24-28``) and cast each
update back, rounding once; without it (``keep_master=False``, as
``repro`` trains kimi) each update starts from the parameters cast to
float32.  Gradients of any dtype are cast to float32 first.  For float32
parameters the master equals the parameters.  Adafactor's factored second moment (row
and column statistics of each matrix) is ``repro``'s memory-viable
choice for the 1T-parameter MoE.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch
from torch import nn

Tree = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params)


def _tree(params) -> Tree:
    if isinstance(params, nn.Module):
        return {k: p.detach() for k, p in params.named_parameters()}
    return dict(params)


def _cast_like(src: Tree, ref: Tree) -> Tree:
    return {k: s.to(ref[k].dtype) for k, s in src.items()}


def _master(params: Tree) -> Tree:
    return {k: p.float().clone() for k, p in params.items()}


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.01,
          keep_master: bool = True) -> Optimizer:
    def init(params):
        params = _tree(params)
        z = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
        dev = next(iter(params.values())).device
        st = {"m": z, "v": {k: t.clone() for k, t in z.items()},
              "count": torch.zeros((), dtype=torch.int32, device=dev)}
        if keep_master:
            st["master"] = _master(params)
        return st

    def update(grads, st, params):
        params = _tree(params)
        c = st["count"] + 1
        cf = c.float()
        b1c = 1.0 - torch.pow(torch.tensor(b1, device=cf.device), cf)
        b2c = 1.0 - torch.pow(torch.tensor(b2, device=cf.device), cf)
        g32 = {k: g.float() for k, g in grads.items()}
        m = {k: b1 * st["m"][k] + (1 - b1) * g for k, g in g32.items()}
        v = {k: b2 * st["v"][k] + (1 - b2) * g * g for k, g in g32.items()}
        base = st.get("master", _master(params))
        new_master = {
            k: p - lr * (m[k] / b1c / (torch.sqrt(v[k] / b2c) + eps)
                         + weight_decay * p)
            for k, p in base.items()}
        new_params = _cast_like(new_master, params)
        new_st = {"m": m, "v": v, "count": c}
        if keep_master:
            new_st["master"] = new_master
        return new_params, new_st

    return Optimizer(init, update)


def sgd(lr: float = 0.1) -> Optimizer:
    def init(params):
        dev = next(iter(_tree(params).values())).device
        return {"count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, st, params):
        params = _tree(params)
        new_params = {k: (p.float() - lr * grads[k].float()).to(p.dtype)
                      for k, p in params.items()}
        return new_params, {"count": st["count"] + 1}

    return Optimizer(init, update)


def adafactor(lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, keep_master: bool = True
              ) -> Optimizer:
    """Factored second moment (Shazeer & Stern): a tensor of 2 or more
    dimensions keeps the mean of g^2 over its last axis (``vr``) and over
    its second-to-last (``vc``), anything else the full ``v``; each update
    is clipped to RMS ``clip_threshold``."""

    def init(params):
        params = _tree(params)

        def stat(p):
            z = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}
        dev = next(iter(params.values())).device
        st = {"stats": {k: stat(p) for k, p in params.items()},
              "count": torch.zeros((), dtype=torch.int32, device=dev)}
        if keep_master:
            st["master"] = _master(params)
        return st

    def update(grads, st, params):
        params = _tree(params)
        c = st["count"] + 1
        beta = 1.0 - torch.pow(c.float(), -decay)

        def upd(g, s, p):
            g = g.float()
            g2 = g * g + eps
            if p.dim() >= 2:
                vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                    min=eps)
                prec = (vr[..., None] / denom[..., None]) * vc[..., None, :]
                u = g * torch.rsqrt(torch.clamp(prec, min=eps))
                news = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(torch.clamp(v, min=eps))
                news = {"v": v}
            rms = torch.sqrt(torch.mean(u * u) + 1e-12)
            return u / torch.clamp(rms / clip_threshold, min=1.0), news

        ups, stats = {}, {}
        for k, p in params.items():
            ups[k], stats[k] = upd(grads[k], st["stats"][k], p)
        base = st.get("master", _master(params))
        new_master = {k: b - lr * ups[k] for k, b in base.items()}
        new_params = _cast_like(new_master, params)
        new_st = {"stats": stats, "count": c}
        if keep_master:
            new_st["master"] = new_master
        return new_params, new_st

    return Optimizer(init, update)


def make_optimizer(name: str, **kw) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor, "sgd": sgd}[name](**kw)

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

Under a mesh (:mod:`repro_torch.distributed`) each optimizer's
``update_sharded(grads, state, params, specs, mesh)`` takes this rank's
shards: the parameters' and gradients' by ``specs["params"]``, the
state's by ``specs["opt"]`` (ZeRO-1: ``m``, ``v``, ``master`` and
Adafactor's ``stats`` split once more over 'data').  AdamW and SGD are
elementwise: each rank updates its ZeRO slice and the parameter shard is
gathered back over 'data'.  Adafactor's row and column means and its RMS
clip sum over the ranks that hold a factored dimension's parts; its
statistics are brought to the parameter shard's layout for the update
and cut back to their own for storage.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..distributed import sharding as sh

Tree = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params)
    # (grads, state, params, specs, mesh): the same step on this rank's shards
    update_sharded: Optional[Callable[..., Tuple[Any, Any]]] = None


def _tree(params) -> Tree:
    if isinstance(params, nn.Module):
        return {k: p.detach() for k, p in params.named_parameters()}
    return dict(params)


def _cast_like(src: Tree, ref: Tree) -> Tree:
    return {k: s.to(ref[k].dtype) for k, s in src.items()}


def _master(params: Tree) -> Tree:
    return {k: p.float().clone() for k, p in params.items()}


def _zero_elementwise(update):
    """``update_sharded`` of an elementwise optimizer: the step on this
    rank's ZeRO-1 slice of every leaf, the new parameter slices gathered
    back over the axes ZeRO-1 added."""
    def update_sharded(grads, st, params, specs, mesh):
        params = _tree(params)
        zs = next((specs["opt"][k] for k in ("m", "master")
                   if k in specs["opt"]), None)
        if zs is None:              # no per-leaf state: the shards as they are
            return update(grads, st, params)
        ps = specs["params"]
        gz = {k: sh.narrow_extra(g, ps[k], zs[k], mesh)
              for k, g in grads.items()}
        pz = {k: sh.narrow_extra(p, ps[k], zs[k], mesh)
              for k, p in params.items()}
        new_pz, new_st = update(gz, st, pz)
        return sh.gather_extra(new_pz, ps, zs, mesh), new_st
    return update_sharded


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

    return Optimizer(init, update, _zero_elementwise(update))


def sgd(lr: float = 0.1) -> Optimizer:
    def init(params):
        dev = next(iter(_tree(params).values())).device
        return {"count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, st, params):
        params = _tree(params)
        new_params = {k: (p.float() - lr * grads[k].float()).to(p.dtype)
                      for k, p in params.items()}
        return new_params, {"count": st["count"] + 1}

    return Optimizer(init, update, _zero_elementwise(update))


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

    def upd(g, s, p, beta, mean=_mean, mean_all=torch.mean):
        """One leaf's clipped update and new statistics.  ``mean(x,
        dim, pdim, keepdim)`` averages x over its dim ``dim`` (the
        parameter's dim ``pdim``), ``mean_all`` over every element."""
        g = g.float()
        g2 = g * g + eps
        if p.dim() >= 2:
            n = p.dim()
            vr = beta * s["vr"] + (1 - beta) * mean(g2, -1, n - 1)
            vc = beta * s["vc"] + (1 - beta) * mean(g2, -2, n - 2)
            denom = torch.clamp(mean(vr, -1, n - 2, keepdim=True), min=eps)
            prec = (vr[..., None] / denom[..., None]) * vc[..., None, :]
            u = g * torch.rsqrt(torch.clamp(prec, min=eps))
            news = {"vr": vr, "vc": vc}
        else:
            v = beta * s["v"] + (1 - beta) * g2
            u = g * torch.rsqrt(torch.clamp(v, min=eps))
            news = {"v": v}
        rms = torch.sqrt(mean_all(u * u) + 1e-12)
        return u / torch.clamp(rms / clip_threshold, min=1.0), news

    def finish(ups, stats, st, params, c):
        base = st.get("master", _master(params))
        new_master = {k: b - lr * ups[k] for k, b in base.items()}
        new_params = _cast_like(new_master, params)
        new_st = {"stats": stats, "count": c}
        if keep_master:
            new_st["master"] = new_master
        return new_params, new_st

    def update(grads, st, params):
        params = _tree(params)
        c = st["count"] + 1
        beta = 1.0 - torch.pow(c.float(), -decay)
        ups, stats = {}, {}
        for k, p in params.items():
            ups[k], stats[k] = upd(grads[k], st["stats"][k], p, beta)
        return finish(ups, stats, st, params, c)

    def update_sharded(grads, st, params, specs, mesh):
        params = _tree(params)
        c = st["count"] + 1
        beta = 1.0 - torch.pow(c.float(), -decay)
        ps, ss = specs["params"], specs["opt"]["stats"]
        ups, stats = {}, {}
        for k, p in params.items():
            spec = sh.layout(ps[k]) + (None,) * (p.dim() - len(ps[k]))
            views = _stat_views(spec, p.dim())
            s = {n: sh.narrow_to(sh.gather(t, ss[k][n], mesh), views[n], mesh)
                 for n, t in st["stats"][k].items()}
            u, new = upd(grads[k], s, p, beta, _sharded_mean(spec, mesh),
                         _sharded_mean_all(spec, mesh))
            ups[k] = u
            stats[k] = {n: sh.shard(sh.gather(t, views[n], mesh),
                                    ss[k][n], mesh) for n, t in new.items()}
        if "master" not in st:
            return finish(ups, stats, st, params, c)
        zs = specs["opt"]["master"]
        uz = {k: sh.narrow_extra(u, ps[k], zs[k], mesh)
              for k, u in ups.items()}
        pz = {k: sh.narrow_extra(p, ps[k], zs[k], mesh)
              for k, p in params.items()}
        new_pz, new_st = finish(uz, stats, st, pz, c)
        return sh.gather_extra(new_pz, ps, zs, mesh), new_st

    return Optimizer(init, update, update_sharded)


def _mean(x, dim, pdim, keepdim=False):
    return torch.mean(x, dim=dim, keepdim=keepdim)


def _stat_views(spec, ndim):
    """The specs of a leaf's statistics laid out as its shard (``vr``
    drops the last dim, ``vc`` the second-to-last)."""
    if ndim >= 2:
        return {"vr": spec[:-1], "vc": spec[:-2] + spec[-1:]}
    return {"v": spec}


def _sharded_mean(spec, mesh):
    """``mean(x, dim, pdim)`` over a dimension the parameter's ``spec``
    may split: the local sum added over the ranks holding its parts."""
    def mean(x, dim, pdim, keepdim=False):
        axes = sh.axes_of(spec[pdim])
        if mesh.n(axes) == 1:
            return torch.mean(x, dim=dim, keepdim=keepdim)
        total = mesh.all_reduce(torch.sum(x, dim=dim, keepdim=keepdim), axes)
        return total / (x.shape[dim] * mesh.n(axes))
    return mean


def _sharded_mean_all(spec, mesh):
    axes = sh.spec_axes(spec)

    def mean_all(x):
        if mesh.n(axes) == 1:
            return torch.mean(x)
        return mesh.all_reduce(torch.sum(x), axes) / (x.numel() *
                                                      mesh.n(axes))
    return mean_all


def make_optimizer(name: str, **kw) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor, "sgd": sgd}[name](**kw)

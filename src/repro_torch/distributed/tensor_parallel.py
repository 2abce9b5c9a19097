"""Tensor-parallel blocks over a mesh's 'model' axis, and the working
model a sharded training step computes with and a sharded serve serves
(:func:`serving_model`).

Where ``repro``'s rules put a leaf's output dimension on 'model', the
leaf is column-parallel (``wq`` / ``wk`` / ``wv`` / ``bq`` / ``bk`` /
``bv``, ``w_up`` / ``w_gate``, the RG-LRU's ``w_x``, ``w_gate_br``,
``conv_w``, ``w_a``, ``w_i`` and its per-channel leaves); ``wo``,
``w_down`` and the RG-LRU's ``w_out`` are row-parallel, their block
output one sum over the 'model' slice.  The pairing is Megatron's, the
one ``repro``'s comment says GSPMD emits: :func:`enter` is the identity
forward and a sum backward, :func:`leave` a sum forward and the identity
backward, so activations and their gradients between blocks are whole on
every rank of a slice.  The RG-LRU's gate projections read every channel
of the convolved input: :func:`gather_last` gathers it forward and sums
and cuts its gradient backward.

A block runs attention on its rank's heads only where the 'model' slice
holds whole q and kv heads (both head counts divide it); its MLP where
the width divides; the RG-LRU scan on the rank's channels where
``d_model`` divides.  Every other sharded leaf -- dims on 'data' (the
expert banks), the embedding and the LM head, attention whose heads the
slice would split -- is gathered whole for its use, and that part of the
model runs whole on every rank of the slice (its gradient then is the
same on each, and is cut back to the shard).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..configs.base import ArchConfig
from .sharding import (Spec, axes_of, gather_many, layout, local_shape,
                       param_pspecs, rule_bytes, shard, tp_size)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, "model"), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[-1]
        return mesh.all_gather(x, "model", dim=x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        full = m.all_reduce(g.contiguous(), "model")
        return full.narrow(-1, m.index("model") * ctx.n, ctx.n), None


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """Which parts of a block run on the rank's share of 'model' (the
    rest is gathered whole)."""
    size: int
    attn: bool      # self and cross attention on local heads
    mlp: bool       # the dense MLP on local columns
    shared: bool    # a MoE block's shared expert on local columns
    rg: bool        # the RG-LRU on local channels

    def local(self, name: str) -> bool:
        """Whether the leaf ``name`` is used as its 'model' shard."""
        owner = name.split(".")[-2] if "." in name else ""
        return {"attn": self.attn, "xattn": self.attn, "mlp": self.mlp,
                "shared": self.shared, "rg": self.rg}.get(owner, False)


def tp_plan(cfg: ArchConfig, tp: int) -> TPPlan:
    width = cfg.dense_ff or cfg.d_ff
    shared = cfg.d_ff * (cfg.moe.n_shared if cfg.moe else 0)
    return TPPlan(size=tp,
                  attn=cfg.n_heads % tp == 0 and cfg.kv_heads % tp == 0,
                  mlp=width % tp == 0, shared=shared % tp == 0,
                  rg=cfg.d_model % tp == 0)


class BlockTP:
    """A block's tensor-parallel hooks over this rank's 'model' slice
    (``Block.tp``; None runs the block whole)."""

    def __init__(self, mesh, plan: TPPlan):
        self.mesh, self.plan = mesh, plan
        self.size = plan.size

    def enter(self, x):
        """Into a column-parallel product: identity, gradient summed."""
        return _Enter.apply(x, self.mesh)

    def leave(self, x):
        """Out of a row-parallel product: summed, gradient as is."""
        return _Leave.apply(x, self.mesh)

    def gather_last(self, x):
        """Every rank's channels along the last dim (gradient summed and
        cut back)."""
        return _GatherLast.apply(x, self.mesh)


def working_spec(name: str, spec: Spec, plan: TPPlan) -> Spec:
    """The spec of the leaf as the forward uses it: its 'model' shard
    where the plan keeps it local, else whole."""
    if not plan.local(name):
        return (None,) * len(spec)
    return tuple(e if "model" in axes_of(e) else None for e in layout(spec))


def attach(model, mesh, plan: TPPlan) -> None:
    """Give every block of ``model`` (and of its encoder) the hooks of
    ``plan`` over ``mesh``'s 'model' slice; a slice of one rank gets
    none."""
    tp = BlockTP(mesh, plan) if plan.size > 1 else None
    blocks = list(model.blocks)
    if getattr(model, "encoder", None) is not None:
        blocks += list(model.encoder.blocks)
    for blk in blocks:
        blk.tp = tp


def working_model(model, specs: Dict[str, Spec], mesh, plan: TPPlan):
    """The model the forward of a sharded step runs: each leaf gathered
    whole, or to its 'model' shard where ``plan`` keeps it local
    (:func:`working_spec`), in a new model with the blocks' TP hooks.
    Where no leaf needs a gather, ``model`` itself (hooks attached)."""
    from ..models.transformer import Transformer
    wspec = {n: working_spec(n, s, plan) for n, s in specs.items()}
    shapes = {n: local_shape(model.full_shapes[n], wspec[n], mesh)
              for n in wspec}
    if all(tuple(p.shape) == shapes[n] for n, p in model.named_parameters()):
        attach(model, mesh, plan)
        return model
    work = Transformer(model.cfg, device=model.device, dtype=model.dtype,
                       shape_of=lambda n, s: shapes[n])
    names = [n for n, _ in model.named_parameters()]
    # a local leaf keeps its 'model' split: gathered over its other axes
    gspecs = [tuple(None if plan.local(n) and "model" in axes_of(e) else e
                    for e in layout(specs[n])) for n in names]
    full = gather_many([p.detach() for p in model.parameters()], gspecs,
                       mesh)
    with torch.no_grad():
        for w, t in zip(work.parameters(), full):
            w.copy_(t)
    attach(work, mesh, plan)
    return work


@torch.no_grad()
def serving_model(cfg: ArchConfig, seed: int, device, dtype, mesh,
                  whole=None):
    """The model a serve on ``mesh`` runs, built once for the run: this
    rank's shards of ``init_model(cfg, seed, device, dtype)`` by
    ``repro``'s rules (each leaf drawn whole on ``device`` and cut, as a
    sharded training state is drawn), then the working model of
    :func:`working_model` -- a leaf at its 'model' shard where the plan
    keeps it local, else gathered whole -- so no decode step gathers a
    parameter.  The shards are dropped once the working model holds
    them.  With ``whole`` (the whole model, ``cfg``'s leaves, on this
    rank) the shards are cut from it instead of drawn.  Returns
    ``(model, bytes)``: ``bytes`` the rank's ``shards``
    and working ``params`` as allocated, each beside the rules' count
    (``shards_rule``, ``params_rule``)."""
    from ..models.transformer import Transformer, init_model
    meta = Transformer(cfg, device="meta", dtype=dtype)
    specs = param_pspecs(meta, cfg, mesh)
    plan = tp_plan(cfg, tp_size(mesh))
    shape_of = lambda n, s: local_shape(s, specs[n], mesh)  # noqa: E731
    if whole is None:
        shards = init_model(cfg, seed, device=device, dtype=dtype,
                            shape_of=shape_of,
                            cut=lambda n, w: shard(w, specs[n], mesh))
    else:
        shards = Transformer(cfg, device=whole.device, dtype=whole.dtype,
                             shape_of=shape_of)
        for (n, p), q in zip(whole.named_parameters(), shards.parameters()):
            q.copy_(shard(p.detach(), specs[n], mesh))
    if shards.device.type == "cuda":     # the whole leaves' draws
        torch.cuda.empty_cache()
    nbytes = {"shards": _allocated(shards),
              "shards_rule": rule_bytes(meta, specs, mesh)}
    work = working_model(shards, specs, mesh, plan)
    del shards
    nbytes["params"] = _allocated(work)
    nbytes["params_rule"] = rule_bytes(
        meta, {n: working_spec(n, s, plan) for n, s in specs.items()}, mesh)
    return work, nbytes


def _allocated(model) -> int:
    return sum(f.numel() * f.element_size() for f in model.flats.values())

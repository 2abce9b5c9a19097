"""DP-SGD gradient machinery: clip + noise, two granularities.

* ``example`` mode -- true per-example clipping.  The per-example
  gradients are written row by row into one float32 ``[B, P]`` matrix
  (a bfloat16 model's bfloat16 gradients cast exactly),
  and the flatten/clip/accumulate step is
  :func:`repro_torch.kernels.dp_clip_noise.dp_clip_accumulate`: the two
  Hopper kernels on the card, their twins on the CPU.
* ``microbatch`` mode -- FL client/cohort-level clipping: the batch is
  split into ``n_micro`` slices, each slice's mean gradient is clipped as
  a unit (DP-FedAvg semantics) and accumulated in place (memory: 2x
  grads, not B x).

Noise is added once after aggregation: std = sigma * clip / n_units, drawn
from a ``torch.Generator`` on the gradients' device.

A gradient *tree* here is a ``{name: tensor}`` dict in the model's
parameter order.  A bfloat16 model's gradients are bfloat16 (its float32
leaves' float32); norms, clipping, sums and noise are float32, as in
``repro`` (``dp_sgd.py:25-37``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from ..distributed.sharding import dp_axes
from ..kernels.dp_clip_noise import clip_scales, dp_clip_accumulate
from ..models.transformer import (Transformer, forward_with, lm_loss_parts,
                                  unflatten)


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(l.float() ** 2) for l in tree.values()))


def clip_by_global_norm(tree: Dict[str, torch.Tensor], clip: float):
    n = global_norm(tree)
    scale = clip_scales(n, clip)
    return {k: l.float() * scale for k, l in tree.items()}, n


def add_noise(tree, generator: torch.Generator, std: float):
    """``tree + std * N(0, 1)`` for a ``{name: tensor}`` dict or a single
    tensor, from ``generator`` (on the tensors' device)."""
    def noisy(l):
        return l + std * torch.randn(l.shape, generator=generator,
                                     dtype=torch.float32, device=l.device)
    if isinstance(tree, torch.Tensor):
        return noisy(tree)
    return {k: noisy(l) for k, l in tree.items()}


def _slice(batch: Dict, lo: int, hi: int) -> Dict:
    return {k: v[lo:hi] for k, v in batch.items()}


def dp_gradients(
    loss_fn: Callable[[Transformer, Dict], torch.Tensor],
    params: Transformer,
    batch: Dict,
    generator: torch.Generator,
    *,
    clip: float = 1.0,
    noise_multiplier: float = 0.0,
    mode: str = "microbatch",
    n_micro: int = 8,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Returns (noised mean clipped grads float32 ``{name: tensor}``,
    metrics).

    batch leaves have leading dim B; it is split into n_micro slices
    (microbatch mode) or B per-example units (example mode), every leaf
    alike: a model's memory or encoder frames travel with their tokens,
    an example's as a batch of one (``repro`` vmaps ``x[None]``).
    """
    weights = list(params.parameters())
    B = next(iter(batch.values())).shape[0]

    if mode == "example":
        G = torch.empty((B, params.n_params), dtype=torch.float32,
                        device=params.device)
        losses = []
        for b in range(B):
            loss = loss_fn(params, _slice(batch, b, b + 1))
            grads = torch.autograd.grad(loss, weights)
            torch.cat([g.reshape(-1).float() for g in grads], out=G[b])
            losses.append(loss.detach())
        gsum, norms = dp_clip_accumulate(G, clip)
        gsum = unflatten(params, gsum)
        n_units = B
    elif mode == "microbatch":
        if B % n_micro:
            raise ValueError(f"batch {B} is not a multiple of n_micro "
                             f"{n_micro}")
        m = B // n_micro
        gsum = {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.named_parameters()}
        norms, losses = [], []
        for i in range(n_micro):
            loss = loss_fn(params, _slice(batch, i * m, (i + 1) * m))
            grads = torch.autograd.grad(loss, weights)
            # clip_by_global_norm's values, added leaf by leaf in place:
            # one leaf's clipped copy at a time, not the whole tree's
            n = global_norm(dict(zip(gsum, grads)))
            scale = clip_scales(n, clip)
            for acc, g in zip(gsum.values(), grads):
                acc.add_(g.float() * scale)
            del grads
            norms.append(n)
            losses.append(loss.detach())
        norms = torch.stack(norms)
        n_units = n_micro
    else:
        raise ValueError(f"unknown DP mode {mode!r}")

    for g in gsum.values():           # the mean in place: one tree, not two
        g.div_(n_units)
    gmean = gsum
    if noise_multiplier > 0.0:
        gmean = add_noise(gmean, generator, noise_multiplier * clip / n_units)
    losses = torch.stack(losses)
    metrics = {"grad_norm_mean": torch.mean(norms),
               "grad_norm_max": torch.max(norms),
               "clip_frac": torch.mean((norms > clip).float()),
               "loss_mean": torch.mean(losses)}
    return gmean, metrics


# ------------------------------------------------------------- under a mesh
def _local_rows(B: int, spec, mesh) -> Tuple[int, int]:
    """The global rows ``[lo, hi)`` this rank computes: its DP shard where
    the batch is split over DP, else all of them on the first DP rank and
    none elsewhere (each row counted once in the DP sum)."""
    dp = dp_axes(mesh)
    if spec[0] is not None:
        per = B // mesh.n(dp)
        lo = mesh.index(dp) * per
        return lo, lo + per
    return (0, B) if mesh.index(dp) == 0 else (0, 0)


def sharded_dp_gradients(
    model: Transformer,
    batch: Dict,
    generator: torch.Generator,
    mesh,
    specs: Dict,
    *,
    clip: float = 1.0,
    noise_multiplier: float = 0.0,
    mode: str = "microbatch",
    n_micro: int = 8,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """:func:`dp_gradients` on this rank's shards: returns (this rank's
    shard of the noised mean clipped gradient, float32 ``{name: tensor}``,
    metrics, the same on every rank).

    ``model`` holds this rank's parameter shards (``specs``, by
    :func:`repro_torch.distributed.param_pspecs`); ``batch`` is the global
    batch, whose rows this rank takes by ``batch_pspecs``.  A unit is
    ``repro``'s: microbatch ``i`` the *global* rows ``[i B/n, (i+1)
    B/n)``, an example one row; ``mode="none"`` one unit of the whole
    batch, unclipped.  The forward runs on the working model
    (:func:`repro_torch.distributed.tensor_parallel.working_model`); a
    MoE block dispatches this rank's tokens of a unit in its share of the
    config's ``moe_dispatch_groups``.

    * microbatch: where each microbatch lies on one DP rank, that rank
      clips it (the norm's squares summed over its 'model' slice, a leaf
      whole on every 'model' rank counted on the first) and the clipped
      sums add over the DP ranks once; where a microbatch spans DP ranks
      (and for ``none``), each rank's rows give their part of the unit's
      mean gradient, summed over the DP ranks, and the clip norm sums
      every leaf's squares once (a replicated leaf on one of its
      replicas) over all ranks.
    * example: each rank's examples' gradients, its share of the
      parameter vector (the leaves it holds a 'model' part of; the
      leaves whole on every 'model' rank on the first of them), form one
      float32 ``[B_local, P_local]`` matrix; ``rownorms`` gives its rows'
      partial squared norms, summed over the 'model' slice, and
      ``clip_accumulate`` sums the rows with those global scales; the
      sums add over the DP ranks.

    Noise is drawn leaf by leaf at the full shape from ``generator``, as
    the one-rank step draws it, and each rank keeps its shard."""
    from ..distributed import sharding as sh
    from ..distributed.tensor_parallel import tp_plan, working_model
    cfg = model.cfg
    plan = tp_plan(cfg, sh.tp_size(mesh))
    work = working_model(model, specs, mesh, plan)
    weights = list(work.parameters())
    names = [k for k, _ in work.named_parameters()]
    dp = dp_axes(mesh)
    B = next(iter(batch.values())).shape[0]
    lo, hi = _local_rows(B, next(iter(sh.batch_pspecs(batch, mesh)
                                      .values())), mesh)
    dev = model.device
    model_sharded = {n: "model" in sh.spec_axes(specs[n]) for n in names}

    def unit(u0, u1, spread=True):
        """(loss part, gradients as the working model holds them) of this
        rank's rows of global rows [u0, u1); ``spread``: the unit's rows
        may lie on several DP ranks (every DP rank calls this for it), so
        its token count is summed over them."""
        r0, r1 = max(u0, lo), min(u1, hi)
        part = {k: v[r0:r1] for k, v in batch.items()} if r1 > r0 else None
        mask = None if part is None else part.get("mask")
        count = torch.zeros((), device=dev) if part is None else (
            torch.sum(mask.float()) if mask is not None else
            torch.tensor(float(part["labels"].numel()), device=dev))
        if spread:
            count = mesh.all_reduce(count, dp)
        if part is None:
            return (torch.zeros((), device=dev),
                    [torch.zeros_like(w) for w in weights])
        lcfg = cfg
        if cfg.moe is not None:     # this rank's share of the unit's groups
            groups = cfg.moe_dispatch_groups * (r1 - r0)
            if groups % (u1 - u0):
                raise ValueError(
                    f"{r1 - r0} of a unit's {u1 - u0} rows do not hold "
                    f"whole MoE dispatch groups of "
                    f"{cfg.moe_dispatch_groups}")
            lcfg = dataclasses.replace(cfg, moe_dispatch_groups=groups //
                                       (u1 - u0))
        logits = forward_with(work, part["tokens"], lcfg,
                              memory=part.get("memory"),
                              enc_frames=part.get("enc_frames"))
        s, _ = lm_loss_parts(logits, part["labels"], mask)
        loss = s / torch.clamp(count, min=1.0)
        return loss.detach(), torch.autograd.grad(loss, weights)

    def model_view(n, g):
        """A working gradient cut to this rank's 'model' part."""
        return g if plan.local(n) else sh.narrow_to(g, specs[n], mesh,
                                                    ("model",))

    def to_shards(views):
        """Model views summed over the DP ranks, cut to the shards."""
        if mesh.n(dp) > 1:
            flat = mesh.all_reduce(torch.cat([v.reshape(-1).float()
                                              for v in views]), dp)
            out, off = [], 0
            for v in views:
                out.append(flat[off:off + v.numel()].view(v.shape))
                off += v.numel()
            views = out
        return {n: sh.narrow_to(v, specs[n], mesh, dp).float()
                for n, v in zip(names, views)}

    def owned(n):
        axes = sh.spec_axes(specs[n])
        return all(mesh.coords[a] == 0 for a in mesh.axis_names
                   if a not in axes)

    def owned_in_slice(n):          # once in the 'model' slice
        return model_sharded[n] or mesh.coords["model"] == 0

    n_units = n_micro if mode == "microbatch" else 1
    if mode in ("microbatch", "none") and B % n_units:
        raise ValueError(f"batch {B} is not a multiple of n_micro "
                         f"{n_units}")
    m = B // n_units
    if mode == "microbatch" and (hi - lo) % m == 0 and lo % m == 0:
        # every microbatch on one DP rank: each rank clips its own units
        # (norms summed over its 'model' slice) and the clipped sums add
        # over the DP ranks once
        acc = None
        norms_all = torch.zeros(n_units, dtype=torch.float32, device=dev)
        loss_all = torch.zeros(n_units, dtype=torch.float32, device=dev)
        for i in range(lo // m, hi // m):
            loss, grads = unit(i * m, (i + 1) * m, spread=False)
            views = [model_view(n, t) for n, t in zip(names, grads)]
            del grads
            sq = sum(torch.sum(v.float() ** 2) for n, v in zip(names, views)
                     if owned_in_slice(n))
            if isinstance(sq, int):
                sq = torch.zeros((), device=dev)
            n = torch.sqrt(mesh.all_reduce(sq, ("model",)))
            scale = clip_scales(n, clip)
            if acc is None:
                acc = [torch.zeros_like(v, dtype=torch.float32)
                       for v in views]
            for a, v in zip(acc, views):
                a.add_(v.float() * scale)
            norms_all[i], loss_all[i] = n, loss
        if acc is None:
            acc = [torch.zeros(model_view(n, w).shape, dtype=torch.float32,
                               device=dev) for n, w in zip(names, weights)]
        gsum = to_shards(acc)
        norms = mesh.all_reduce(norms_all, dp)
        losses = list(mesh.all_reduce(loss_all, dp))
    elif mode in ("microbatch", "none"):
        gsum = None
        norms, losses = [], []
        for i in range(n_units):
            loss, grads = unit(i * m, (i + 1) * m)
            g = to_shards([model_view(n, t) for n, t in zip(names, grads)])
            del grads
            losses.append(mesh.all_reduce(loss, dp))
            if mode == "none":
                gsum = g
                break
            sq = sum(torch.sum(t.float() ** 2) for n, t in g.items()
                     if owned(n))
            if isinstance(sq, int):
                sq = torch.zeros((), device=dev)
            n = torch.sqrt(mesh.all_reduce(sq, mesh.axis_names))
            scale = clip_scales(n, clip)
            if gsum is None:
                gsum = {k: torch.zeros_like(t) for k, t in g.items()}
            for acc, t in zip(gsum.values(), g.values()):
                acc.add_(t * scale)
            norms.append(n)
        if mode == "none":
            return gsum, {"grad_norm_mean": torch.zeros((), device=dev),
                          "loss_mean": losses[0]}
        norms = torch.stack(norms)
    elif mode == "example":
        from ..kernels.dp_clip_noise import dp_accumulate, dp_rownorms_sq
        n_units = B
        own = [n for n in names if owned_in_slice(n)]
        rep = [n for n in names if not model_sharded[n]]
        sizes = {n: model_view(n, w).numel() for n, w in zip(names, weights)}
        G = torch.empty((hi - lo, sum(sizes[n] for n in own)),
                        dtype=torch.float32, device=dev)
        norms_all = torch.zeros(B, dtype=torch.float32, device=dev)
        loss_all = torch.zeros(B, dtype=torch.float32, device=dev)
        for b in range(lo, hi):
            loss, grads = unit(b, b + 1, spread=False)
            views = dict(zip(names, (model_view(n, t)
                                     for n, t in zip(names, grads))))
            torch.cat([views[n].reshape(-1).float() for n in own],
                      out=G[b - lo])
            loss_all[b] = loss
            del grads, views
        if hi > lo:
            sq = mesh.all_reduce(dp_rownorms_sq(G), ("model",))
            norms_loc = torch.sqrt(sq)
            acc = dp_accumulate(G, clip_scales(norms_loc, clip))
            norms_all[lo:hi] = norms_loc
        else:
            acc = torch.zeros(G.shape[1], dtype=torch.float32, device=dev)
        del G
        acc = mesh.all_reduce(acc, dp)
        views, off = {}, 0
        for n in own:
            views[n] = acc[off:off + sizes[n]]
            off += sizes[n]
        if mesh.shape["model"] > 1:     # replicated leaves from model rank 0
            first = mesh.coords["model"] == 0
            vec = torch.cat([views[n] for n in rep]) if first else None
            like = torch.empty(sum(sizes[n] for n in rep), device=dev)
            vec = mesh.from_first(vec, ("model",), like)
            off = 0
            for n in rep:
                views[n] = vec[off:off + sizes[n]]
                off += sizes[n]
        shapes = {n: model_view(n, w).shape for n, w in zip(names, weights)}
        gsum = {n: sh.narrow_to(views[n].view(shapes[n]), specs[n], mesh, dp)
                .clone() for n in names}
        norms = mesh.all_reduce(norms_all, dp)
        losses = list(mesh.all_reduce(loss_all, dp))
    else:
        raise ValueError(f"unknown DP mode {mode!r}")

    for g in gsum.values():           # the mean in place: one tree, not two
        g.div_(n_units)
    if noise_multiplier > 0.0:
        std = noise_multiplier * clip / n_units
        for n, g in gsum.items():
            full = torch.randn(model.full_shapes[n], generator=generator,
                               dtype=torch.float32, device=dev)
            gsum[n] = g + std * sh.narrow_to(full, specs[n], mesh)
    losses = torch.stack(losses)
    metrics = {"grad_norm_mean": torch.mean(norms),
               "grad_norm_max": torch.max(norms),
               "clip_frac": torch.mean((norms > clip).float()),
               "loss_mean": torch.mean(losses)}
    return gsum, metrics

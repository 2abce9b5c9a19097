"""Logical sharding rules -> per-dimension specs for every parameter,
optimizer, batch and cache leaf, and the shards they describe.

The rules are ``repro``'s (``repro/distributed/sharding.py``), copied:
the same names, the same divisibility fallbacks, the same ZeRO-1 step.
Mesh contract (:mod:`repro_torch.launch.mesh`): single pod ('data',
'model') = (16, 16); multi-pod ('pod', 'data', 'model') = (2, 16, 16).
DP runs over ('pod', 'data'); TP/EP over 'model'.

A *spec* is a tuple with one entry a dimension, as a ``PartitionSpec``
lists them: ``None`` (whole), an axis name, or a tuple of axis names (the
dimension split over their product, the first name major).  A mesh is
anything with ``axis_names`` and a ``shape`` mapping of axis sizes, so a
duck-typed stand-in gives the production specs without the ranks.

``repro`` stacks the repeating body for ``lax.scan``, so a body leaf
carries a leading ``n_groups`` dimension and its spec a leading ``None``;
the port keeps every layer as its own leaf (``Transformer``'s
``blocks.<i>``), so its spec is ``repro``'s without that entry.
``_base_rank`` is kept as ``repro`` has it (``b_i`` twice, the gates rank
0): ``param_pspecs`` applies the same leading-dims arithmetic to the
port's leaves.

Beside the rules: each rank's local shape under a spec
(:func:`local_shape`), the cut of a full tensor into this rank's shard
(:func:`shard`) and the gather of the shards back into the full tensor
(:func:`gather`).  ``repro``'s ``_zero1`` may name 'data' a second time
on a leaf the rules already shard over 'data' (an expert bank on a small
mesh; JAX refuses such a spec, so ``repro`` never runs it): the shards
follow :func:`layout`, which keeps an axis at its first dimension only.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..configs.base import ArchConfig

Spec = Tuple[Any, ...]


# ------------------------------------------------------------------ helpers
def tp_size(mesh) -> int:
    return mesh.shape["model"]


def dp_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def dp_size(mesh) -> int:
    s = 1
    for a in dp_axes(mesh):
        s *= mesh.shape[a]
    return s


def _div(n: int, tp: int) -> bool:
    return n % tp == 0


# ------------------------------------------------------------- param rules
def _rule(names, shape, cfg: ArchConfig, tp: int, nd: int = 1):
    """Trailing-dims spec tuple for one param leaf (``repro``'s, line for
    line)."""
    name = names[-1]
    in_moe = "moe" in names
    in_cell = "cell" in names
    in_rg = "rg" in names

    def col(dim=-1, ok=True):
        s = [None] * 2
        s[dim] = "model" if ok and _div(shape[dim], tp) else None
        return tuple(s)

    if in_cell:                      # xLSTM cells: replicated (DP-only arch)
        return (None,) * len(shape)

    if in_moe and name in ("w_up", "w_gate", "w_down"):
        # expert banks: EP over 'model' (TP on the ffn dim when E does not
        # divide), plus FSDP over 'data' on the first remaining divisible dim
        if _div(cfg.moe.n_experts, tp):
            spec = ["model", None, None]
        elif name == "w_down":
            spec = [None, "model" if _div(shape[-2], tp) else None, None]
        else:
            spec = [None, None, "model" if _div(shape[-1], tp) else None]
        for i in range(3):
            if spec[i] is None and _div(shape[i], nd) and shape[i] >= nd:
                spec[i] = "data"
                break
        return tuple(spec)
    if name == "router":
        return (None, None)

    if in_rg:
        two = {"w_x": col(), "w_gate_br": col(), "conv_w": col(),
               "w_a": col(), "w_i": col(),
               "w_out": (("model" if _div(shape[0], tp) else None), None)}
        one = {"conv_b", "b_a", "b_i", "lambda"}
        if name in two:
            return two[name]
        if name in one:
            return ("model" if _div(shape[0], tp) else None,)
        return (None,) * len(shape)

    if name == "table":              # embedding [V, D]
        if _div(shape[0], tp):
            return ("model", None)
        return (None, "model" if _div(shape[1], tp) else None)
    if name == "w" and "lm_head" in names:    # [D, V]
        if _div(shape[1], tp):
            return (None, "model")
        return ("model" if _div(shape[0], tp) else None, None)

    # attention projections shard on the flattened heads*dh dim even when
    # the heads do not divide tp; wo is row-parallel
    if name == "wq":
        return col()
    if name in ("wk", "wv"):
        return col()
    if name == "wo":
        return (("model" if _div(shape[0], tp) else None), None)
    if name in ("bq", "bk", "bv"):
        return ("model" if _div(shape[0], tp) else None,)

    if name in ("w_up", "w_gate"):   # dense MLP [D, F]
        return col()
    if name == "w_down":             # [F, D]
        return (("model" if _div(shape[0], tp) else None), None)

    return (None,) * len(shape)      # norms, gates, scalars


def _base_rank(names, cfg) -> int:
    name = names[-1]
    if "moe" in names and name in ("w_up", "w_gate", "w_down"):
        return 3
    if "cell" in names and name == "r":
        return 3
    if name in ("conv_b", "b_a", "b_i", "lambda", "bq", "bk", "bv", "b_in",
                "scale", "bias", "b_f", "b_i"):
        return 1
    if name in ("gate_x", "gate_m"):
        return 0
    return 2


def _named_shapes(params) -> Dict[str, Tuple[int, ...]]:
    """``{name: shape}`` of a model (its ``named_parameters()``) or of a
    ``{name: tensor or shape}`` mapping."""
    if isinstance(params, torch.nn.Module):
        return {k: tuple(p.shape) for k, p in params.named_parameters()}
    return {k: tuple(getattr(v, "shape", v)) for k, v in params.items()}


def param_pspecs(params, cfg: ArchConfig, mesh) -> Dict[str, Spec]:
    """``{name: spec}`` for a model's parameters (a ``Transformer``, or
    ``{name: tensor or full shape}``), by ``repro``'s rules on the full
    shapes."""
    tp = tp_size(mesh)
    nd = mesh.shape["data"]
    out = {}
    for name, shape in _named_shapes(params).items():
        names = name.split(".")
        lead = len(shape) - _base_rank(names, cfg)
        base = _rule(names, shape[lead:], cfg, tp, nd)
        out[name] = (None,) * lead + tuple(base)
    return out


def rule_bytes(model, specs: Dict[str, Spec], mesh) -> int:
    """Bytes of a rank's leaves of ``model`` (a ``Transformer``; a
    ``meta`` one will do) under ``specs``: each leaf's local shape of its
    full shape, times its dtype's size."""
    return sum(math.prod(local_shape(model.full_shapes[n], specs[n], mesh))
               * p.dtype.itemsize for n, p in model.named_parameters())


# -------------------------------------------------------- batch/cache rules
def _dp_entry(mesh):
    """The DP axes as one spec entry (a lone axis by its name, as a
    ``PartitionSpec`` normalises it)."""
    dp = dp_axes(mesh)
    return dp[0] if len(dp) == 1 else dp


def batch_pspecs(batch_tree, mesh):
    """tokens/labels [B,S] -> (dp, None); memory/frames [B,L,D] -> (dp,
    ...).  The leading batch dim shards over DP only when divisible.
    ``batch_tree`` is a dict (nested dicts, lists and tuples too) of
    tensors or anything with ``shape``; the specs take its structure."""
    dp = _dp_entry(mesh)
    n_dp = dp_size(mesh)

    def fn(leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape:
            return ()
        lead = dp if shape[0] % n_dp == 0 and shape[0] >= n_dp else None
        return (lead,) + (None,) * (len(shape) - 1)

    return _tree_map(fn, batch_tree)


def cache_pspecs(cache_tree, mesh, batch_size: int):
    """KV caches / recurrent states: shard the batch dim over DP, found by
    size -- the first dim equal to ``batch_size`` within the leading two
    positions (``repro``'s stacked leaves carry ``n_groups`` first)."""
    dp = _dp_entry(mesh)
    n_dp = dp_size(mesh)

    def fn(leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape:
            return ()
        spec = [None] * len(shape)
        if batch_size % n_dp == 0 and batch_size >= n_dp:
            for i in range(min(2, len(shape))):
                if shape[i] == batch_size:
                    spec[i] = dp
                    break
        return tuple(spec)

    return _tree_map(fn, cache_tree)


class CacheLeaf(NamedTuple):
    """One cache leaf of a serve on a mesh (:func:`cache_layout`)."""
    spec: Spec          # ``repro``'s, ``cache_pspecs``
    layout: Spec        # the shard this rank holds
    shape: Tuple[int, ...]     # the whole leaf
    dtype: torch.dtype


def _tp_dim(kind: str, name: str, plan) -> Optional[int]:
    """The dimension of a cache leaf that a tensor-parallel block splits
    over 'model': the KV heads of attention on local heads, the channels
    of an RG-LRU on local channels; xLSTM cells run whole."""
    if name in ("k", "v", "xk", "xv") and plan.attn:
        return 2
    if kind == "rec" and plan.rg:
        return {"conv": 2, "h": 1}[name]
    return None


def cache_layout(cfg: ArchConfig, mesh, batch: int, cache_len: int,
                 dtype=torch.float32) -> List[Dict[str, CacheLeaf]]:
    """Every leaf of the decode cache of a serve of ``batch`` rows and
    ``cache_len`` positions on ``mesh``, block by block: ``repro``'s spec
    (:func:`cache_pspecs`: the batch over the DP axes where it divides,
    else whole), the layout this rank holds, the whole shape and the
    dtype (a model in ``dtype``).  The rank's rows are the spec's; where
    a block runs tensor-parallel (:func:`repro_torch.distributed.
    tensor_parallel.tp_plan`) its KV heads, or a ``rec`` block's ``conv``
    and ``h`` channels, are also split over 'model'.  ``repro`` keeps the
    cache whole across 'model' (its out-shardings); a rank here holds
    only what its heads and channels read."""
    from ..models.kv_cache import meta_cache
    from .tensor_parallel import tp_plan
    cache = meta_cache(cfg, batch, cache_len, dtype=dtype)
    specs = cache_pspecs(cache, mesh, batch)
    plan = tp_plan(cfg, tp_size(mesh))
    out = []
    for (kind, _), entry, spec in zip(cfg.layer_specs(), cache, specs):
        leaves = {}
        for name, t in entry.items():
            lay = list(spec[name])
            d = _tp_dim(kind, name, plan)
            if d is not None and plan.size > 1:
                lay[d] = "model"
            leaves[name] = CacheLeaf(spec[name], tuple(lay), tuple(t.shape),
                                     t.dtype)
        out.append(leaves)
    return out


def cache_bytes(layout: List[Dict[str, CacheLeaf]], mesh) -> Tuple[int, int]:
    """Bytes of a :func:`cache_layout` on a rank: what the rank holds, and
    what ``repro``'s ``cache_pspecs`` alone would give it."""
    held = implied = 0
    for entry in layout:
        for leaf in entry.values():
            size = leaf.dtype.itemsize
            held += size * math.prod(local_shape(leaf.shape, leaf.layout,
                                                 mesh))
            implied += size * math.prod(local_shape(leaf.shape, leaf.spec,
                                                    mesh))
    return held, implied


def gather_cache(cache, layout: List[Dict[str, CacheLeaf]], mesh,
                 device=None) -> List[Dict[str, torch.Tensor]]:
    """The whole cache from every rank's entries under ``layout`` (a
    collective: every rank of the mesh calls it), copied to ``device``
    (default: the entries'), so later decode steps leave it as it is."""
    names = [(i, n) for i, entry in enumerate(layout) for n in entry]
    full = gather_many([cache[i][n] for i, n in names],
                       [layout[i][n].layout for i, n in names], mesh)
    out: List[Dict[str, torch.Tensor]] = [{} for _ in layout]
    for (i, n), t in zip(names, full):
        out[i][n] = t.to(t.device if device is None else device, copy=True)
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _zero1(spec: Spec, shape, data_size: int) -> Spec:
    """ZeRO-1: additionally shard an optimizer-state leaf over 'data' on
    the first still-unsharded divisible dim."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (p, d) in enumerate(zip(parts, shape)):
        if p is None and d % data_size == 0 and d >= data_size:
            parts[i] = "data"
            break
    return tuple(parts)


def state_pspecs(state, cfg: ArchConfig, mesh) -> Dict[str, Any]:
    """Specs of a training state (:func:`repro_torch.training.make_state`:
    ``params``, ``opt``, ``step``, ``seed``): the optimizer's ``m``,
    ``v`` and ``master`` mirror the parameters' specs plus ZeRO-1 over
    'data'; its ``stats`` (Adafactor) take ZeRO-1 on their own shapes;
    scalars are whole."""
    nd = mesh.shape["data"]
    full = _named_shapes(state["params"])
    pspec = param_pspecs(full, cfg, mesh)
    opt = {}
    for key, sub in state["opt"].items():
        if key in ("m", "v", "master"):
            opt[key] = {k: _zero1(pspec[k], full[k], nd) for k in sub}
        elif key == "stats":
            opt[key] = {k: {s: _zero1((None,) * len(t.shape), t.shape, nd)
                            for s, t in st.items()} for k, st in sub.items()}
        else:
            opt[key] = ()
    return {"params": pspec, "opt": opt, "step": (), "seed": ()}


# ---------------------------------------------------------------- layouts
def axes_of(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def layout(spec: Spec) -> Spec:
    """The spec as the shards follow it: an axis named again after its
    first dimension is dropped there (see the module docstring)."""
    seen, out = set(), []
    for entry in spec:
        keep = tuple(a for a in axes_of(entry) if a not in seen)
        seen.update(keep)
        out.append(None if not keep else keep[0] if len(keep) == 1 else keep)
    return tuple(out)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every axis a spec shards over, in order."""
    return tuple(a for e in layout(spec) for a in axes_of(e))


def _parts(entry, mesh) -> int:
    return math.prod(mesh.shape[a] for a in axes_of(entry))


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """A rank's shape of a leaf of full ``shape`` under ``spec``."""
    spec = layout(spec)
    spec = spec + (None,) * (len(shape) - len(spec))
    out = []
    for d, e in zip(shape, spec):
        n = _parts(e, mesh)
        if d % n:
            raise ValueError(f"dim {d} does not split over {axes_of(e)} "
                             f"({n} parts)")
        out.append(d // n)
    return tuple(out)


def shard_index(entry, mesh) -> int:
    """This rank's part of a dimension split over ``entry``'s axes (the
    first axis major)."""
    idx = 0
    for a in axes_of(entry):
        idx = idx * mesh.shape[a] + mesh.coords[a]
    return idx


def shard(full: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's shard of ``full`` under ``spec`` (a new tensor)."""
    out = full
    for d, e in enumerate(layout(spec)):
        n = _parts(e, mesh)
        if n > 1:
            size = full.shape[d] // n
            out = out.narrow(d, shard_index(e, mesh) * size, size)
    return out.clone()


def gather(local: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full tensor from every rank's shard under ``spec`` (a
    collective over each sharded dimension's axes: every rank of those
    groups must call it)."""
    return gather_many([local], [spec], mesh)[0]


def gather_many(tensors, specs, mesh):
    """:func:`gather` of each tensor under its spec, the tensors that
    gather over the same axes (and have one dtype) in one collective
    (``Mesh.all_gather_many``); every rank of the groups calls it with
    the same specs."""
    steps = []
    for spec in specs:
        mine = []
        for d, e in enumerate(layout(spec)):
            axes = axes_of(e)
            if axes and _parts(axes, mesh) > 1:
                mine.append((d, axes))
        steps.append(mine)
    out = list(tensors)
    r = 0
    while any(len(st) > r for st in steps):
        groups = {}
        for i, st in enumerate(steps):
            if len(st) > r:
                d, axes = st[r]
                groups.setdefault((axes, str(out[i].dtype)), []).append(
                    (i, d))
        for key in sorted(groups):          # the same order on every rank
            items = groups[key]
            got = mesh.all_gather_many([out[i] for i, _ in items], key[0],
                                       [d for _, d in items])
            for (i, _), t in zip(items, got):
                out[i] = t
        r += 1
    return out


def _extra(pspec: Spec, zspec: Spec):
    """``(dim, axes)`` where the ZeRO-1 spec ``zspec`` splits a dimension
    over axes the parameter's ``pspec`` does not."""
    p, z = layout(pspec), layout(zspec)
    p = p + (None,) * (len(z) - len(p))
    return [(d, tuple(a for a in axes_of(ze) if a not in axes_of(pe)))
            for d, (pe, ze) in enumerate(zip(p, z))
            if set(axes_of(ze)) - set(axes_of(pe))]


def narrow_extra(t: torch.Tensor, pspec: Spec, zspec: Spec, mesh
                 ) -> torch.Tensor:
    """A parameter shard cut to its ZeRO-1 slice (a view)."""
    for d, axes in _extra(pspec, zspec):
        size = t.shape[d] // mesh.n(axes)
        t = t.narrow(d, mesh.index(axes) * size, size)
    return t


def gather_extra(ts: Dict[str, torch.Tensor], pspecs, zspecs, mesh
                 ) -> Dict[str, torch.Tensor]:
    """ZeRO-1 slices ``{name: slice}`` gathered back into the parameter
    shards (batched as :func:`gather_many`)."""
    names = list(ts)
    extra = []
    for n in names:
        spec = [None] * len(layout(zspecs[n]))
        for d, axes in _extra(pspecs[n], zspecs[n]):
            spec[d] = axes[0] if len(axes) == 1 else axes
        extra.append(tuple(spec))
    return dict(zip(names, gather_many([ts[n] for n in names], extra,
                                       mesh)))


def narrow_to(t: torch.Tensor, spec: Spec, mesh, axes=None) -> torch.Tensor:
    """``t`` cut to this rank's part along each dimension ``spec`` splits
    over (only over ``axes`` where given; a view)."""
    for d, e in enumerate(layout(spec)):
        ax = tuple(a for a in axes_of(e) if axes is None or a in axes)
        if not ax or mesh.n(ax) == 1:
            continue
        size = t.shape[d] // mesh.n(ax)
        t = t.narrow(d, mesh.index(ax) * size, size)
    return t

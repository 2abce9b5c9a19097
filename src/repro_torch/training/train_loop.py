"""Step builders: the training step of ``repro``'s training launcher and
the serving step.

``train_step`` is ``repro``'s DP-FedAvg-style step (cohort-clipped
gradients plus noise, then the optimizer) run eagerly: ``repro`` jits it,
PyTorch has no counterpart the port needs.  It updates the model in
place (as :func:`repro_torch.training.fedavg.fl_round` does) and returns
a new optimizer state.  ``serve_step`` is ``repro``'s decode step plus
sampling.

Under a mesh (:mod:`repro_torch.launch.mesh`) the state is sharded by
``repro``'s rules (:func:`repro_torch.distributed.state_pspecs`): a
rank's ``params`` is a ``Transformer`` whose leaves have their local
shapes (its flat buffers hold shards), its optimizer state is its ZeRO-1
slices, and :func:`train_step` runs the step on them across the ranks
(:func:`repro_torch.training.dp_sgd.sharded_dp_gradients`, each
optimizer's ``update_sharded``).  :func:`shard_state` and
:func:`gather_state` cut a full state into a rank's shards and gather the
shards back, bitwise both ways.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..distributed import sharding as sh
from ..models import decode_step, forward, init_model, lm_loss
from ..models.transformer import Transformer
from .dp_sgd import dp_gradients, sharded_dp_gradients
from .optimizer import Optimizer, make_optimizer


@dataclasses.dataclass(frozen=True)
class DPConfig:
    clip: float = 1.0
    noise_multiplier: float = 0.0   # 0 disables noise (set from RDP grant)
    mode: str = "microbatch"        # microbatch (client-level) | example
    n_micro: int = 8


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"
    lr: float = 3e-4
    weight_decay: float = 0.01
    dp: DPConfig = DPConfig()
    remat: bool = True
    param_dtype: str = "bfloat16"
    keep_master: bool = True

    def make_optimizer(self) -> Optimizer:
        if self.optimizer == "adamw":
            return make_optimizer("adamw", lr=self.lr,
                                  weight_decay=self.weight_decay,
                                  keep_master=self.keep_master)
        if self.optimizer == "adafactor":
            return make_optimizer("adafactor", lr=self.lr,
                                  keep_master=self.keep_master)
        return make_optimizer("sgd", lr=self.lr)


PARAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def param_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ``TrainConfig.param_dtype`` name."""
    if name not in PARAM_DTYPES:
        raise ValueError(f"param_dtype {name!r}: one of "
                         f"{sorted(PARAM_DTYPES)}")
    return PARAM_DTYPES[name]


def make_state(seed: int, cfg: ArchConfig, tcfg: TrainConfig,
               device="cuda", mesh=None) -> Dict[str, Any]:
    """Parameters from :func:`repro_torch.models.init_model` (seeded
    ``torch.Generator``) in ``tcfg.param_dtype`` (``"float32"`` or
    ``"bfloat16"``; the dataclass's default is ``repro``'s, bfloat16), the
    optimizer's state (for bfloat16 parameters with a float32 master
    unless ``tcfg.keep_master`` is False, as ``repro`` trains kimi), the
    step count and the seed.  ``device`` defaults to CUDA and raises
    without it.  A model with cross attention trains on batches that
    carry its ``memory`` (or an encoder-decoder's ``enc_frames``), [B, L,
    d_model] in the parameter dtype, beside the tokens.  On the ``meta``
    device nothing is drawn or allocated (the shapes alone).  Under
    ``mesh`` each rank holds only its shards (:func:`shard_state`'s of
    the full state, bitwise): the parameters are drawn a leaf at a time
    and cut (:func:`repro_torch.models.init_model`'s ``shape_of``), the
    optimizer state is made at its ZeRO-1 slices."""
    dtype = param_dtype(tcfg.param_dtype)
    if mesh is not None:
        return _sharded_state(seed, cfg, tcfg, device, mesh)
    if torch.device(device).type == "meta":
        params = Transformer(cfg, device="meta", dtype=dtype)
    else:
        params = init_model(cfg, seed, device=device, dtype=dtype)
    opt = tcfg.make_optimizer().init(params)
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32,
                                device=params.device),
            "seed": seed}


@torch.no_grad()
def _sharded_state(seed: int, cfg: ArchConfig, tcfg: TrainConfig, device,
                   mesh) -> Dict[str, Any]:
    """:func:`make_state` under ``mesh``: this rank's shards, without
    the full state."""
    ps = state_layout(cfg, tcfg, mesh)["params"]
    params = init_model(
        cfg, seed, device=device, dtype=param_dtype(tcfg.param_dtype),
        shape_of=lambda n, s: sh.local_shape(s, ps[n], mesh),
        cut=lambda n, w: sh.shard(w, ps[n], mesh))
    return {"params": params, "opt": sharded_opt_init(params, cfg, tcfg,
                                                       mesh),
            "step": torch.zeros((), dtype=torch.int32, device=params.device),
            "seed": seed}


@torch.no_grad()
def sharded_opt_init(params: Transformer, cfg: ArchConfig,
                     tcfg: TrainConfig, mesh) -> Dict[str, Any]:
    """The optimizer's initial state on this rank's parameter shards
    ``params``, made at its ZeRO-1 slices (:func:`shard_state`'s of the
    full initial state, bitwise): every leaf zero but the master, the
    parameters in float32, cut from the shards."""
    specs = state_layout(cfg, tcfg, mesh)
    ps, local = specs["params"], dict(params.named_parameters())
    dev = params.device

    def leaf(key, n, t, spec):
        if key == "master":
            return sh.narrow_extra(local[n].detach().float(), ps[n], spec,
                                   mesh).clone()
        return torch.zeros(sh.local_shape(t.shape, spec, mesh),
                           dtype=t.dtype, device=dev)
    opt = {}
    for key, v in make_state(0, cfg, tcfg, device="meta")["opt"].items():
        if not isinstance(v, dict):
            opt[key] = torch.zeros(v.shape, dtype=v.dtype, device=dev)
        elif key == "stats":
            opt[key] = {n: {s: leaf(key, n, t, specs["opt"][key][n][s])
                            for s, t in st.items()} for n, st in v.items()}
        else:
            opt[key] = {n: leaf(key, n, t, specs["opt"][key][n])
                        for n, t in v.items()}
    return opt


class _Shape:
    """A mesh's axis names and sizes alone."""

    def __init__(self, axis_names, sizes):
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, sizes))


@functools.lru_cache(maxsize=None)
def _layout(cfg: ArchConfig, tcfg: TrainConfig, axis_names, sizes):
    meta = make_state(0, cfg, tcfg, device="meta")
    return sh.state_pspecs(meta, cfg, _Shape(axis_names, sizes))


def state_layout(cfg: ArchConfig, tcfg: TrainConfig, mesh):
    """The specs of the training state of ``cfg`` under ``tcfg`` on
    ``mesh`` (``state_pspecs`` of its ``meta`` state)."""
    names = tuple(mesh.axis_names)
    return _layout(cfg, tcfg, names, tuple(mesh.shape[a] for a in names))


def _map_opt(fn, opt, specs):
    """``fn(tensor, spec)`` over the optimizer state's per-leaf trees."""
    out = {}
    for k, v in opt.items():
        if k == "stats":
            out[k] = {n: {s: fn(t, specs[k][n][s]) for s, t in st.items()}
                      for n, st in v.items()}
        elif isinstance(v, dict):
            out[k] = {n: fn(t, specs[k][n]) for n, t in v.items()}
        else:
            out[k] = v
    return out


@torch.no_grad()
def shard_state(state: Dict[str, Any], cfg: ArchConfig, mesh
                ) -> Dict[str, Any]:
    """This rank's shards of a full training state (``make_state``'s or a
    restored checkpoint's), on the state's device."""
    specs = sh.state_pspecs(state, cfg, mesh)
    full = state["params"]
    model = Transformer(cfg, device=full.device, dtype=full.dtype,
                        shape_of=lambda n, s: sh.local_shape(
                            s, specs["params"][n], mesh))
    for (n, p), q in zip(full.named_parameters(), model.parameters()):
        q.copy_(sh.shard(p.detach(), specs["params"][n], mesh))
    return {"params": model,
            "opt": _map_opt(lambda t, sp: sh.shard(t, sp, mesh),
                            state["opt"], specs["opt"]),
            "step": state["step"].clone(), "seed": state["seed"]}


@torch.no_grad()
def gather_state(state: Dict[str, Any], cfg: ArchConfig, tcfg: TrainConfig,
                 mesh, device=None) -> Dict[str, Any]:
    """The full training state from every rank's shards (a collective:
    every rank of the mesh calls it and gets it), on ``device`` (default:
    the shards')."""
    specs = state_layout(cfg, tcfg, mesh)
    local = state["params"]
    dev = local.device if device is None else torch.device(device)
    model = Transformer(cfg, device=dev, dtype=local.dtype)
    names = [n for n, _ in local.named_parameters()]
    full = sh.gather_many([p.detach() for p in local.parameters()],
                          [specs["params"][n] for n in names], mesh)
    for q, t in zip(model.parameters(), full):
        q.copy_(t)
    opt = {}
    for k, v in state["opt"].items():
        if not isinstance(v, dict):
            opt[k] = v.to(dev)
            continue
        leaves = [(n, s) for n, t in v.items()
                  for s in (t if isinstance(t, dict) else [None])]
        got = sh.gather_many(
            [v[n] if s is None else v[n][s] for n, s in leaves],
            [specs["opt"][k][n] if s is None else specs["opt"][k][n][s]
             for n, s in leaves], mesh)
        opt[k] = {}
        for (n, s), t in zip(leaves, got):
            if s is None:
                opt[k][n] = t.to(dev)
            else:
                opt[k].setdefault(n, {})[s] = t.to(dev)
    return {"params": model, "opt": opt,
            "step": state["step"].to(dev), "seed": state["seed"]}


def make_loss_fn(cfg: ArchConfig, remat: bool = True):
    """``loss_fn(params, batch)``: mean token cross-entropy of the model
    on ``batch["tokens"]`` against ``batch["labels"]`` (optional
    ``batch["mask"]``), reading ``batch["memory"]`` or
    ``batch["enc_frames"]`` where the model cross-attends.  ``remat`` is
    accepted and ignored (module docstring of
    :mod:`repro_torch.models.transformer`)."""
    def loss_fn(params, batch):
        logits = forward(params, batch["tokens"], cfg,
                         memory=batch.get("memory"),
                         enc_frames=batch.get("enc_frames"))
        return lm_loss(logits, batch["labels"], batch.get("mask"))
    return loss_fn


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The noise generator of step ``step``: a ``torch.Generator`` on
    ``device`` seeded from ``(seed, step)`` alone (numpy's
    ``SeedSequence``), as ``repro`` folds the step into its key, so a
    resumed run draws the same noise as an uninterrupted one."""
    word = np.random.SeedSequence([int(seed), int(step)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(word))


def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor],
               cfg: ArchConfig, tcfg: TrainConfig, mesh=None
               ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """One DP-FedAvg-style training step (cohort-clipped gradients and
    noise, then the optimizer).  ``state`` is :func:`make_state`'s; its
    model is updated in place and returned in the new state, with the
    optimizer's new state, ``step + 1`` and the seed.  Metrics: ``loss``
    and ``grad_norm_mean`` (and, under DP, ``grad_norm_max`` and
    ``clip_frac``), device scalars.  ``remat`` is accepted and ignored
    (:mod:`repro_torch.models.transformer`).  Under ``mesh`` the state is
    this rank's shards (:func:`make_state` with the mesh) and ``batch``
    the global batch, whose rows each rank takes by ``batch_pspecs``;
    every rank calls the step and gets the same metrics."""
    model = state["params"]
    gen = step_generator(state["seed"], int(state["step"]), model.device)
    opt = tcfg.make_optimizer()
    if mesh is None:
        (grads, metrics), loss = _grads_with_loss(
            make_loss_fn(cfg, tcfg.remat), model, batch, gen, tcfg)
        new_params, new_opt = opt.update(grads, state["opt"], model)
    else:
        specs = state_layout(cfg, tcfg, mesh)
        grads, metrics = sharded_gradients(state, batch, cfg, tcfg, mesh, gen)
        loss = metrics.pop("loss_mean")
        new_params, new_opt = opt.update_sharded(grads, state["opt"], model,
                                                 specs, mesh)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(new_params[name])
    new_state = {"params": model, "opt": new_opt,
                 "step": state["step"] + 1, "seed": state["seed"]}
    return new_state, {"loss": loss, **metrics}


def sharded_gradients(state, batch, cfg: ArchConfig, tcfg: TrainConfig,
                      mesh, generator: torch.Generator):
    """This rank's shards of the step's gradients before the optimizer,
    and the step's metrics (``loss_mean`` among them): the sharded
    :func:`_grads_with_loss`."""
    specs = state_layout(cfg, tcfg, mesh)
    dp = tcfg.dp
    return sharded_dp_gradients(
        state["params"], batch, generator, mesh, specs["params"],
        clip=dp.clip, noise_multiplier=dp.noise_multiplier, mode=dp.mode,
        n_micro=dp.n_micro)


def _grads_with_loss(loss_fn, params, batch, generator: torch.Generator,
                     tcfg: TrainConfig):
    """``((grads {name: float32 tensor}, metrics), loss)``: plain
    gradients (in the parameters' dtype, cast to float32 as ``repro``
    casts them) for DP mode ``none``, else :func:`dp_gradients`' noised
    mean of clipped units (``microbatch`` or ``example``) and its mean
    unit loss."""
    dp = tcfg.dp
    if dp.mode == "none":
        loss = loss_fn(params, batch)
        names = [k for k, _ in params.named_parameters()]
        grads = torch.autograd.grad(loss, list(params.parameters()))
        return ({k: g.float() for k, g in zip(names, grads)},
                {"grad_norm_mean": torch.zeros((), device=loss.device)}), \
            loss.detach()
    grads, metrics = dp_gradients(
        loss_fn, params, batch, generator, clip=dp.clip,
        noise_multiplier=dp.noise_multiplier, mode=dp.mode,
        n_micro=dp.n_micro)
    loss = metrics.pop("loss_mean")
    return (grads, metrics), loss


def serve_step(params, token, cache, pos: int, cfg: ArchConfig,
               temperature: float = 0.0,
               generator: Optional[torch.Generator] = None):
    """One decode step and sampling.  Returns ``(next_token [B, 1],
    logits [B, 1, vocab], cache)``.

    ``temperature <= 0`` is greedy (argmax, first index on ties, as
    ``jnp.argmax``).  Otherwise the token is drawn by the Gumbel-max rule
    of ``jax.random.categorical`` from ``generator``, a ``torch.Generator``
    on the logits' device: reproducible from its seed, but not the same
    draws as ``repro``'s ``jax.random`` key."""
    logits, cache = decode_step(params, token, cache, pos, cfg)
    last = logits[:, -1]
    if temperature <= 0.0:
        nxt = torch.argmax(last, dim=-1)
    else:
        if generator is None:
            raise ValueError("sampling (temperature > 0) needs a generator")
        u = torch.rand(last.shape, generator=generator, device=last.device)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
        nxt = torch.argmax(last / temperature + gumbel, dim=-1)
    return nxt[:, None].to(token.dtype), logits, cache

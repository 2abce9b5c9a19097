"""Step builders: the training step of ``repro``'s training launcher and
the serving step.

``train_step`` is ``repro``'s DP-FedAvg-style step (cohort-clipped
gradients plus noise, then the optimizer) run eagerly: ``repro`` jits it,
PyTorch has no counterpart the port needs.  It updates the model in
place (as :func:`repro_torch.training.fedavg.fl_round` does) and returns
a new optimizer state.  ``serve_step`` is ``repro``'s decode step plus
sampling.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..models import decode_step, forward, init_model, lm_loss
from .dp_sgd import dp_gradients
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
               device="cuda") -> Dict[str, Any]:
    """Parameters from :func:`repro_torch.models.init_model` (seeded
    ``torch.Generator``) in ``tcfg.param_dtype`` (``"float32"`` or
    ``"bfloat16"``; the dataclass's default is ``repro``'s, bfloat16), the
    optimizer's state (for bfloat16 parameters with a float32 master
    unless ``tcfg.keep_master`` is False, as ``repro`` trains kimi), the
    step count and the seed.  ``device`` defaults to CUDA and raises
    without it.  A model with cross attention trains on batches that
    carry its ``memory`` (or an encoder-decoder's ``enc_frames``), [B, L,
    d_model] in the parameter dtype, beside the tokens."""
    params = init_model(cfg, seed, device=device,
                        dtype=param_dtype(tcfg.param_dtype))
    opt = tcfg.make_optimizer().init(params)
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32,
                                device=params.device),
            "seed": seed}


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
               cfg: ArchConfig, tcfg: TrainConfig
               ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """One DP-FedAvg-style training step (cohort-clipped gradients and
    noise, then the optimizer).  ``state`` is :func:`make_state`'s; its
    model is updated in place and returned in the new state, with the
    optimizer's new state, ``step + 1`` and the seed.  Metrics: ``loss``
    and ``grad_norm_mean`` (and, under DP, ``grad_norm_max`` and
    ``clip_frac``), device scalars.  ``remat`` is accepted and ignored
    (:mod:`repro_torch.models.transformer`)."""
    model = state["params"]
    gen = step_generator(state["seed"], int(state["step"]), model.device)
    (grads, metrics), loss = _grads_with_loss(
        make_loss_fn(cfg, tcfg.remat), model, batch, gen, tcfg)
    new_params, new_opt = tcfg.make_optimizer().update(
        grads, state["opt"], model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(new_params[name])
    new_state = {"params": model, "opt": new_opt,
                 "step": state["step"] + 1, "seed": state["seed"]}
    return new_state, {"loss": loss, **metrics}


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

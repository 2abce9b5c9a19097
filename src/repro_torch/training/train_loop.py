"""Training state, loss builders and the serving step.

``serve_step`` is ``repro``'s decode step plus sampling.  ``train_step``
(the jitted whole-batch step of ``repro``'s training launcher) is not in
the port yet; the FL path trains through
:mod:`repro_torch.training.fedavg` (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..configs.base import ArchConfig
from ..models import decode_step, forward, init_model, lm_loss
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


def make_state(seed: int, cfg: ArchConfig, tcfg: TrainConfig,
               device="cuda") -> Dict[str, Any]:
    """Parameters from :func:`repro_torch.models.init_model` (seeded
    ``torch.Generator``), the optimizer's state, the step count and the
    seed.  ``device`` defaults to CUDA and raises without it.  Only
    ``param_dtype="float32"`` is in this slice."""
    if tcfg.param_dtype != "float32":
        raise NotImplementedError(
            f"param_dtype {tcfg.param_dtype!r}: the port trains float32 "
            "parameters only (ROADMAP.md, Queue 1)")
    params = init_model(cfg, seed, device=device)
    opt = tcfg.make_optimizer().init(params)
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32,
                                device=params.flat.device),
            "seed": seed}


def make_loss_fn(cfg: ArchConfig, remat: bool = True):
    """``loss_fn(params, batch)``: mean token cross-entropy of the model
    on ``batch["tokens"]`` against ``batch["labels"]`` (optional
    ``batch["mask"]``).  ``remat`` is accepted and ignored (module
    docstring of :mod:`repro_torch.models.transformer`)."""
    def loss_fn(params, batch):
        logits = forward(params, batch["tokens"], cfg)
        return lm_loss(logits, batch["labels"], batch.get("mask"))
    return loss_fn


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

"""Mesh-specialised configurations and the training state's shapes
without allocation: the parts of ``repro/launch/specs.py`` that are not
XLA lowering.

``repro``'s ``input_specs``, ``cache_specs`` and ``build_cell`` feed the
lowering of its dry-run and roofline tools; the port's H100 counterparts
of those tools are not written yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from ..configs.base import ArchConfig, ShapeSpec
from ..distributed.sharding import dp_size
from ..training.train_loop import DPConfig, TrainConfig, make_state


def arch_for_mesh(cfg: ArchConfig, mesh, shape: ShapeSpec) -> ArchConfig:
    """Mesh- and shape-specialised config (MoE dispatch groups = DP
    shards, halved until they divide the batch's tokens; whisper's cross
    memory = the cell's sequence length)."""
    upd: Dict[str, Any] = {}
    if cfg.moe is not None:
        g = dp_size(mesh)
        b_tokens = shape.global_batch * (shape.seq_len
                                         if shape.kind != "decode" else 1)
        while g > 1 and b_tokens % g:
            g //= 2
        upd["moe_dispatch_groups"] = max(g, 1)
    if cfg.encoder is not None:
        upd["cross_memory_len"] = shape.seq_len
    if upd:
        cfg = dataclasses.replace(cfg, **upd)
    return cfg


def train_config_for(cfg: ArchConfig, shape: ShapeSpec) -> TrainConfig:
    """Per-arch training config: Adafactor without a float32 master for
    the 1T MoE, AdamW elsewhere; bfloat16 parameters; 8 microbatches
    where the batch divides."""
    kimi = cfg.name.startswith("kimi")
    n_micro = 8 if shape.global_batch % 8 == 0 else 1
    return TrainConfig(optimizer="adafactor" if kimi else "adamw",
                       dp=DPConfig(n_micro=n_micro),
                       param_dtype="bfloat16", keep_master=not kimi)


def state_specs(cfg: ArchConfig, tcfg: TrainConfig) -> Dict[str, Any]:
    """The full training state of ``cfg`` under ``tcfg`` on the ``meta``
    device: every shape and dtype, nothing allocated."""
    return make_state(0, cfg, tcfg, device="meta")

"""Training launcher: the counterpart of ``repro/launch/train.py``.

Builds the training state of one architecture, restores the latest
checkpoint if there is one, and runs the DP-FedAvg train step
(:func:`repro_torch.training.train_step`) on ``synth_tokens`` batches,
saving every ``--ckpt-every`` steps: the same flags, defaults, training
configuration and flow as ``repro``'s launcher on one device (float32
parameters, AdamW -- Adafactor for ``kimi*`` -- and two microbatches
when the batch is even).  A resumed run runs ``--steps`` more steps from
the restored one.  ``repro``'s production mesh and its state sharding
(``--multi-pod``, ``state_pspecs``) are not ported and raise.

    PYTHONPATH=src python -m repro_torch.launch.train          # H100, full
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import torch

from .. import resolve_device
from ..checkpoint import CheckpointManager
from ..configs import get_arch, reduced
from ..data.pipeline import synth_tokens
from ..training import DPConfig, TrainConfig, make_state, train_step

DEFAULT_CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt")


def train_config(cfg, batch: int, noise: float, clip: float) -> TrainConfig:
    """``repro``'s launcher's configuration on one device."""
    return TrainConfig(
        optimizer="adafactor" if cfg.name.startswith("kimi") else "adamw",
        param_dtype="float32",
        dp=DPConfig(clip=clip, noise_multiplier=noise,
                    n_micro=2 if batch % 2 == 0 else 1))


def run(arch: str = "flaas-100m", steps: int = 20, batch: int = 8,
        seq: int = 128, smoke: bool = False, ckpt: str = DEFAULT_CKPT,
        ckpt_every: int = 10, noise: float = 0.2, clip: float = 1.0,
        device="cuda", multi_pod: bool = False,
        log: Optional[Callable[[str], None]] = print) -> Dict:
    """Train ``steps`` steps from the latest checkpoint in ``ckpt`` (or
    from step 0), saving every ``ckpt_every``.  Returns ``{"cfg", "tcfg",
    "state", "records", "resumed_from", "checkpoints"}``: one record per
    step (``step``, ``loss``, ``grad_norm_mean``, ``grad_norm_max``,
    ``clip_frac``, ``wall_s``, host clock around a step that ends in a
    device read).  ``device`` defaults to CUDA and raises without it."""
    if multi_pod:
        raise NotImplementedError("the production mesh (--multi-pod) and "
                                  "state sharding are not ported "
                                  "(ROADMAP.md, Queue 1 item 11)")
    dev = resolve_device(device)
    say = log or (lambda _: None)
    cfg = get_arch(arch)
    if smoke:
        cfg = reduced(cfg)
    say(f"arch={cfg.name} device={dev} devices=1")
    tcfg = train_config(cfg, batch, noise, clip)
    state = make_state(0, cfg, tcfg, device=dev)
    mgr = CheckpointManager(ckpt, keep_n=3, async_save=True)
    restored, at = mgr.restore(state)
    start = 0
    if restored is not None:
        state, start = restored, at
        say(f"resumed from step {at}")

    records = []
    for i in range(start, start + steps):
        b = {k: torch.as_tensor(v, device=dev)
             for k, v in synth_tokens(i, batch, seq, cfg.vocab).items()}
        t0 = time.perf_counter()
        state, m = train_step(state, b, cfg, tcfg)
        rec = {"step": i, **{k: float(v) for k, v in m.items()},
               "wall_s": time.perf_counter() - t0}
        records.append(rec)
        say(f"step {i:5d}  loss={rec['loss']:.4f}  "
            f"gnorm={rec['grad_norm_mean']:.3f}  {rec['wall_s']:.2f}s")
        if (i + 1) % ckpt_every == 0:
            mgr.save(i + 1, state)
    mgr.wait()
    say(f"final checkpoints: {mgr.all_steps()}")
    return {"cfg": cfg, "tcfg": tcfg, "state": state, "records": records,
            "resumed_from": at, "checkpoints": mgr.all_steps()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="flaas-100m")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--noise", type=float, default=0.2)
    ap.add_argument("--clip", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.arch, args.steps, args.batch, args.seq, args.smoke, args.ckpt,
        args.ckpt_every, args.noise, args.clip, args.device, args.multi_pod)


if __name__ == "__main__":
    main()

"""Training launcher: the counterpart of ``repro/launch/train.py``.

Builds the training state of one architecture, restores the latest
checkpoint if there is one, and runs the DP-FedAvg train step
(:func:`repro_torch.training.train_step`) on ``synth_tokens`` batches,
saving every ``--ckpt-every`` steps: the same flags, defaults, training
configuration and flow as ``repro``'s launcher on one device (float32
parameters, AdamW -- Adafactor for ``kimi*`` -- and two microbatches
when the batch is even); :func:`run` also takes ``param_dtype="bfloat16"``,
``repro``'s choice on more than one device (a float32 master in the
optimizer; checkpoints store the bfloat16 leaves bitwise).  A model with cross attention
(``llama-3.2-vision-11b``, ``whisper-medium``) gets its memory or encoder
frames beside every batch: zeros, as ``repro``'s serving launcher gives
(:func:`repro_torch.launch.inputs.cross_inputs`), or the tensor
:func:`run` is given; ``repro``'s own train launcher feeds such a model
no memory and cannot train it.  A resumed run runs ``--steps`` more steps
from the restored one.

With ``torch.distributed`` initialised the launcher follows ``repro``'s
rule by world size: the production mesh (``--multi-pod``: the 512-rank
one) when the world has 256 or more ranks, else the host mesh (every
rank a (1, 1) mesh of its own), and bfloat16 parameters when the world
has more than one rank.  :func:`run` also takes any mesh made by
:func:`repro_torch.launch.mesh.make_mesh`.  Under a mesh the state is
sharded by ``repro``'s rules and the step runs on the shards across the
ranks (:func:`repro_torch.training.train_step`); a checkpoint holds the
full leaves, gathered to the first rank, which alone writes it, and each
rank cuts its shards on restore, so one checkpoint resumes under any
mesh.  A fresh state is drawn into each rank's shards, without the full
state; a save and a restore still hold the full state on every rank
(the gather goes to host memory, the restore to ``device``), so a model
whose full training state does not fit one rank's memory trains on a
mesh but cannot yet checkpoint there.

    PYTHONPATH=src python -m repro_torch.launch.train          # H100, full
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --arch kimi-k2-1t-a32b
    # the ranks of a mesh: repro_torch.launch.sharded_train
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
from ..training.train_loop import gather_state, shard_state
from ..training.train_loop import param_dtype as param_dtype_of
from .inputs import cross_inputs
from .mesh import launch_dtype, launch_mesh

DEFAULT_CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt")


def train_config(cfg, batch: int, noise: float, clip: float,
                 param_dtype: str = "float32") -> TrainConfig:
    """``repro``'s launcher's configuration on one device (in
    ``param_dtype``: float32 there)."""
    return TrainConfig(
        optimizer="adafactor" if cfg.name.startswith("kimi") else "adamw",
        param_dtype=param_dtype,
        dp=DPConfig(clip=clip, noise_multiplier=noise,
                    n_micro=2 if batch % 2 == 0 else 1))


def run(arch: str = "flaas-100m", steps: int = 20, batch: int = 8,
        seq: int = 128, smoke: bool = False, ckpt: str = DEFAULT_CKPT,
        ckpt_every: int = 10, noise: float = 0.2, clip: float = 1.0,
        device="cuda", multi_pod: bool = False,
        log: Optional[Callable[[str], None]] = print,
        memory: Optional[torch.Tensor] = None,
        enc_frames: Optional[torch.Tensor] = None,
        param_dtype: Optional[str] = None, mesh=None) -> Dict:
    """Train ``steps`` steps from the latest checkpoint in ``ckpt`` (or
    from step 0), saving every ``ckpt_every``, with parameters in
    ``param_dtype`` (``"float32"`` or ``"bfloat16"``; None: ``repro``'s
    rule, :func:`launch_dtype`).  Under ``mesh`` (default:
    :func:`launch_mesh` when ``torch.distributed`` is initialised or
    ``multi_pod`` is set; none otherwise) every rank of the mesh calls
    this.  ``memory`` (a model with
    cross attention) or ``enc_frames`` (an encoder-decoder), [batch,
    cross_memory_len, d_model] on any device, go with every batch; without
    them such a model gets zeros.  Returns ``{"cfg", "tcfg",
    "state", "records", "resumed_from", "checkpoints"}``: one record per
    step (``step``, ``loss``, ``grad_norm_mean``, ``grad_norm_max``,
    ``clip_frac``, ``wall_s``, host clock around a step that ends in a
    device read).  ``device`` defaults to CUDA and raises without it."""
    import torch.distributed as dist
    dev = resolve_device(device)
    say = log or (lambda _: None)
    cfg = get_arch(arch)
    if smoke:
        cfg = reduced(cfg)
    on = dist.is_available() and dist.is_initialized()
    if mesh is None and (on or multi_pod):
        mesh = launch_mesh(multi_pod)
    first = not on or dist.get_rank() == 0     # writes the checkpoints
    if param_dtype is None:
        param_dtype = launch_dtype()
    say(f"arch={cfg.name} device={dev} "
        f"devices={dist.get_world_size() if on else 1} "
        f"mesh={None if mesh is None else mesh.shape} "
        f"param_dtype={param_dtype}")
    tcfg = train_config(cfg, batch, noise, clip, param_dtype)
    cross = cross_inputs(cfg, batch, dev, memory, enc_frames,
                         param_dtype_of(param_dtype))
    mgr = CheckpointManager(ckpt, keep_n=3, async_save=True)
    start, at = 0, mgr.latest_step()
    if at is None:          # under a mesh, drawn into the shards
        state = make_state(0, cfg, tcfg, device=dev, mesh=mesh)
    else:
        restored, at = mgr.restore(make_state(0, cfg, tcfg, device=dev))
        state, start = restored, at
        say(f"resumed from step {at}")
        if mesh is not None:
            state = shard_state(state, cfg, mesh)

    records = []
    for i in range(start, start + steps):
        b = {k: torch.as_tensor(v, device=dev)
             for k, v in synth_tokens(i, batch, seq, cfg.vocab).items()}
        b.update(cross)
        t0 = time.perf_counter()
        state, m = train_step(state, b, cfg, tcfg, mesh)
        rec = {"step": i, **{k: float(v) for k, v in m.items()},
               "wall_s": time.perf_counter() - t0}
        records.append(rec)
        say(f"step {i:5d}  loss={rec['loss']:.4f}  "
            f"gnorm={rec['grad_norm_mean']:.3f}  {rec['wall_s']:.2f}s")
        if (i + 1) % ckpt_every == 0:
            full = state if mesh is None else gather_state(
                state, cfg, tcfg, mesh, device="cpu")
            if first:
                mgr.save(i + 1, full)
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

"""Serving launcher: batched prefill, then greedy or sampled decode over a
KV cache, on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve             # H100
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \
        --device cpu --smoke
    # the ranks of a mesh: repro_torch.launch.sharded_serve

``--arch`` takes every architecture the port knows
(:data:`repro_torch.configs.ARCHS`): ``flaas-100m``, the dense
``qwen2.5-3b``, ``qwen2.5-32b``, ``starcoder2-3b`` and ``starcoder2-15b``,
the hybrid ``recurrentgemma-2b`` and ``xlstm-125m``, the cross-attention
``llama-3.2-vision-11b``, the encoder-decoder ``whisper-medium`` and the
MoE ``mixtral-8x22b`` and ``kimi-k2-1t-a32b``.  In float32,
``qwen2.5-32b`` (131 GB), ``mixtral-8x22b`` (563 GB) and
``kimi-k2-1t-a32b`` (4.1 TB) fit no 80 GB card whole; such a model fails
where its parameters are allocated, its size in the message (the
parameters are drawn on the host first, so there); ``--smoke`` serves
the reduced config.  ``llama-3.2-vision-11b`` (39.1 GB) fits.  In
bfloat16 (``run(param_dtype="bfloat16")``, ``repro``'s dtype on more
than one device) ``qwen2.5-32b`` is 65.5 GB and fits one card; a model
that large is best drawn on the card, ``init_model(cfg, seed,
device="cuda", dtype=torch.bfloat16)``, and served with ``model=``: the
host draw takes its whole size in host memory and tens of seconds.

Like ``repro``'s launcher, a model with cross attention is given zeros
as its memory, ``[batch, cross_memory_len, d_model]`` (the vision tower
is a stub), and an encoder-decoder zeros as its encoder frames (the audio
frontend is a stub); :func:`run` takes seeded ones instead (``memory=``,
``enc_frames=``).

The counterpart of ``repro``'s ``launch/serve.py`` with the same flags
(``--multi-pod`` included), plus ``--device`` (default ``cuda``; raises
without it) and ``--seed``.  The first new token is the prefill's argmax
(as in ``repro``), then ``gen - 1`` :func:`serve_step` calls; the cache
holds ``prompt_len + gen`` positions (a recurrent block's state is O(1),
a ``local`` block's ring ``min(window, prompt_len + gen)``).  The prompts
are drawn on the CPU from a generator seeded with ``--seed``.

On one device, parameters are float32, as ``repro`` chooses there, unless
:func:`run` is given ``param_dtype="bfloat16"`` (the K/V cache, a ``rec``
block's convolution state and the memory then bfloat16 too); they are
drawn on the CPU and copied to the device, so runs on the card and on
the CPU serve the same model.

With ``torch.distributed`` initialised the launcher follows ``repro``'s
rule by world size, as ``launch/train.py`` does
(:func:`repro_torch.launch.mesh.launch_mesh`, ``launch_dtype``): the
production mesh (``--multi-pod``: the 512-rank one) at 256 ranks or
more, else the host mesh, and bfloat16 parameters on more than one rank.
:func:`run` also takes any mesh of :func:`repro_torch.launch.mesh.
make_mesh`; every rank of it calls :func:`run`.  Under a mesh each rank
draws its shards of the seeded model on its device, by ``repro``'s rules,
and builds the working model once (:func:`repro_torch.distributed.
tensor_parallel.serving_model`): attention on the rank's heads, the
RG-LRU on its channels and the MLP on its columns where the 'model' size
divides them, the rest whole.  The rows are the rank's share of the
seeded global batch where the DP size divides it, else every row on
every DP rank (``repro``'s ``cache_pspecs``); the cache holds those rows
and the rank's heads and channels
(:func:`repro_torch.distributed.sharding.cache_layout`).  A MoE model
dispatches in ``dispatch_groups(DP size, batch)`` groups over the
batch, each DP rank its own rows as one group where the batch splits.
The tokens and logits a run returns are the whole batch's on every
rank.  A mesh without 'data' and 'model' axes (a pipeline's: ``repro``
serves without pipeline parallelism) raises ``NotImplementedError``.
Spawned ranks serving on a mesh: :mod:`repro_torch.launch.sharded_serve`.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from .. import resolve_device
from ..configs import get_arch, reduced
from ..configs.base import ArchConfig
from ..distributed import sharding as sh
from ..distributed.tensor_parallel import serving_model
from ..kernels import decode_attention as da
from ..kernels import flash_attention as fa
from ..kernels import rg_lru
from ..models import Transformer, forward_with_cache, init_model
from ..training import serve_step
from ..training.train_loop import param_dtype as param_dtype_of
from .inputs import cross_inputs
from .mesh import launch_dtype, launch_mesh
from .specs import dispatch_groups


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches() -> Dict[str, int]:
    return {**fa.LAUNCHES, **da.LAUNCHES, **rg_lru.LAUNCHES}


def make_model(cfg, seed: int, dev: torch.device,
               dtype=torch.float32) -> Transformer:
    """``init_model(cfg, seed, dtype=dtype)`` drawn on the CPU, copied to
    ``dev``."""
    host = init_model(cfg, seed, device="cpu", dtype=dtype)
    if dev.type == "cpu":
        return host
    model = Transformer(cfg, device=dev, dtype=dtype)
    with torch.no_grad():
        for dt, buf in model.flats.items():
            buf.copy_(host.flats[dt])
    return model


def mesh_rows(mesh, batch: int) -> Tuple[int, int]:
    """The global rows ``[lo, hi)`` a rank of ``mesh`` serves: its DP
    shard where the DP size divides ``batch``, else all of them."""
    n_dp = sh.dp_size(mesh)
    if batch % n_dp or batch < n_dp:
        return 0, batch
    per = batch // n_dp
    lo = mesh.index(sh.dp_axes(mesh)) * per
    return lo, lo + per


def mesh_config(cfg: ArchConfig, mesh, batch: int):
    """``(config of the whole batch, config a rank serves its rows
    with)``: for a MoE model ``dispatch_groups(DP size, batch)`` groups
    over the batch (one configuration serves the prefill's tokens and
    each decode step's, so the groups divide the step's ``batch``), and a
    rank's share of them over its rows (one where the batch splits over
    DP); any other model's configuration as it is."""
    if cfg.moe is None:
        return cfg, cfg
    g = dispatch_groups(sh.dp_size(mesh), batch)
    lo, hi = mesh_rows(mesh, batch)
    return (dataclasses.replace(cfg, moe_dispatch_groups=g),
            dataclasses.replace(cfg, moe_dispatch_groups=g * (hi - lo)
                                // batch))


def run(arch="flaas-100m", smoke: bool = False, batch: int = 4,
        prompt_len: int = 32, gen: int = 16, temperature: float = 0.0,
        device="cuda", seed: int = 0, feed: Optional[torch.Tensor] = None,
        keep_logits: bool = False,
        log: Optional[Callable[[str], None]] = print,
        model: Optional[Transformer] = None,
        memory: Optional[torch.Tensor] = None,
        enc_frames: Optional[torch.Tensor] = None,
        param_dtype: Optional[str] = None, mesh=None,
        multi_pod: bool = False, keep_cache: bool = False) -> Dict:
    """Serve ``batch`` seeded prompts of ``prompt_len`` tokens and generate
    ``gen`` tokens each.  ``arch`` is a name of
    :data:`repro_torch.configs.ARCHS` or an ``ArchConfig`` (a cut one, say).
    ``feed`` [batch, gen] (optional) feeds those
    tokens to the decode steps instead of the generated ones (teacher
    forcing; the generated tokens are still recorded).  ``model``
    (optional) is served instead of ``make_model(arch, seed)``, on its own
    device and configuration, so one drawn model can serve several runs;
    ``seed`` then draws only the prompts, and ``arch``, ``smoke``,
    ``device``, ``param_dtype`` and ``multi_pod`` must keep their
    defaults (a second choice raises).  Under a mesh ``model`` is the
    whole model, on every rank, and each rank cuts its shards from it in
    place of drawing them.
    ``memory`` [batch, cross_memory_len, d_model] (a model with cross
    attention) or ``enc_frames`` [batch, cross_memory_len, d_model] (an
    encoder-decoder), on any device, are moved to the model's device and
    dtype and given to the prefill; without them it gets zeros, as
    ``repro``'s launcher gives.  ``param_dtype`` (``"float32"`` or
    ``"bfloat16"``; None: ``repro``'s rule, float32 on one rank) is the
    drawn model's; a ``model=`` keeps its own.  Under ``mesh`` (default:
    :func:`repro_torch.launch.mesh.launch_mesh` when ``torch.distributed``
    is initialised or ``multi_pod`` is set; none otherwise) every rank of
    it calls this (module docstring).  Returns ``{"cfg", "prompts",
    "tokens" [batch, gen], "prefill_ms", "step_ms" (per decode step),
    "tok_per_s", "launches"}`` -- the kernels' launches during the run,
    on this rank -- and, with ``keep_logits``, ``"logits": {"prefill" [B,
    S, V], "decode" [B, gen - 1, V]}`` on the CPU; with ``keep_cache``,
    ``"cache": {"prefill", "final"}``, the whole cache (every row, head
    and channel) after the prefill and after the last step, on the CPU.
    Under a mesh also ``"mesh"``, ``"coords"``, ``"rows"`` (this rank's
    ``[lo, hi)``) and ``"bytes"``: the rank's parameter ``shards`` and
    working ``params`` beside the rules' count (``*_rule``), its
    ``cache`` beside :func:`repro_torch.distributed.sharding.
    cache_layout`'s count (``cache_layout``) and what ``repro``'s
    ``cache_pspecs`` alone would give it (``cache_pspecs``), and
    ``"cache_shapes"``, its entries' shapes.  ``cfg`` is the
    configuration of the whole batch."""
    import torch.distributed as dist
    if gen < 1:
        raise ValueError("gen must be at least 1")
    nbytes = None
    if model is not None:
        if (arch != "flaas-100m" or smoke or str(device) != "cuda"
                or param_dtype is not None or multi_pod):
            raise ValueError("model= serves its own configuration on its "
                             "own device in its own dtype; do not pass arch, "
                             "smoke, device, param_dtype or multi_pod with "
                             "it")
        cfg, dev, dtype = model.cfg, model.device, model.dtype
    else:
        dev = resolve_device(device)
        cfg = get_arch(arch) if isinstance(arch, str) else arch
        if smoke:
            cfg = reduced(cfg)
        if mesh is None and (multi_pod or (dist.is_available()
                                           and dist.is_initialized())):
            mesh = launch_mesh(multi_pod)
        dtype = param_dtype_of(param_dtype or launch_dtype())
    if mesh is not None and not {"data", "model"} <= set(mesh.axis_names):
        raise NotImplementedError(
            f"serving on a mesh of axes {mesh.axis_names}: a mesh with "
            "'data' and 'model' axes (no pipeline-parallel serving)")
    if mesh is None:
        whole_cfg = cfg
        params = model if model is not None else \
            make_model(cfg, seed, dev, dtype)
    else:
        whole_cfg, cfg = mesh_config(cfg, mesh, batch)
        params, nbytes = serving_model(cfg, seed, dev, dtype, mesh,
                                       whole=model)
    lo, hi = (0, batch) if mesh is None else mesh_rows(mesh, batch)
    split = hi - lo < batch

    def whole(t):
        """A tensor of this rank's rows as the whole batch's."""
        return mesh.all_gather(t, sh.dp_axes(mesh), dim=0) if split else t

    cpu_gen = torch.Generator().manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                            generator=cpu_gen, dtype=torch.int32)
    tok_gen = torch.Generator(device=dev).manual_seed(seed)
    prompts_d = prompts[lo:hi].to(dev)
    cross = cross_inputs(cfg, hi - lo, dev,
                         None if memory is None else memory[lo:hi],
                         None if enc_frames is None else enc_frames[lo:hi],
                         params.dtype)
    total = prompt_len + gen
    layout = None if mesh is None else sh.cache_layout(
        cfg, mesh, batch, total, params.dtype)
    if log:
        log(f"arch={cfg.name} device={dev} dtype={params.dtype} "
            f"batch={batch} prompt_len={prompt_len} gen={gen}"
            + ("" if mesh is None else
               f" mesh={mesh.shape} coords={mesh.coords} rows=[{lo}, {hi})"))

    before = _launches()
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = forward_with_cache(params, prompts_d, cfg,
                                       cache_len=total, **cross)
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    out = {"prefill": whole(logits).cpu()} if keep_logits else None
    del logits
    caches = {"prefill": _whole_cache(cache, layout, mesh)} \
        if keep_cache else None
    if nbytes is not None:
        nbytes["cache"] = sum(x.numel() * x.element_size()
                              for entry in cache for x in entry.values())
        nbytes["cache_layout"], nbytes["cache_pspecs"] = sh.cache_bytes(
            layout, mesh)
        cache_shapes = [{n: tuple(x.shape) for n, x in entry.items()}
                        for entry in cache]
    if log:
        log(f"prefill {batch}x{prompt_len}: {prefill_ms / 1e3:.2f}s")

    tokens, step_ms, dec_logits = [tok], [], []
    for i in range(gen - 1):
        inp = tok if feed is None else \
            feed[lo:hi, i:i + 1].to(dev, torch.int32)
        t0 = time.perf_counter()
        tok, lg, cache = serve_step(params, inp, cache, prompt_len + i, cfg,
                                    temperature=temperature,
                                    generator=tok_gen,
                                    rows=(lo, hi, batch) if split else None)
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        tokens.append(tok)
        if keep_logits:
            dec_logits.append(whole(lg[:, 0]).cpu())
    decode_s = sum(step_ms) / 1e3
    tok_per_s = batch * (gen - 1) / max(decode_s, 1e-9)
    if log:
        log(f"decode {gen - 1} steps: {decode_s:.2f}s "
            f"({tok_per_s:.1f} tok/s)")
    rec = {"cfg": whole_cfg, "prompts": prompts,
           "tokens": whole(torch.cat(tokens, dim=1)).cpu(),
           "prefill_ms": prefill_ms, "step_ms": step_ms,
           "tok_per_s": tok_per_s,
           "launches": {n: c - before[n] for n, c in _launches().items()}}
    if keep_logits:
        out["decode"] = (torch.stack(dec_logits, dim=1) if dec_logits else
                         torch.empty(batch, 0, cfg.vocab))
        rec["logits"] = out
    if keep_cache:
        caches["final"] = _whole_cache(cache, layout, mesh)
        rec["cache"] = caches
    if mesh is not None:
        rec.update(mesh=dict(mesh.shape), coords=dict(mesh.coords),
                   rows=(lo, hi), bytes=nbytes, cache_shapes=cache_shapes)
    return rec


def _whole_cache(cache, layout, mesh):
    """The cache of every row, head and channel on the CPU (a copy)."""
    if mesh is None:
        return [{n: x.to("cpu", copy=True) for n, x in entry.items()}
                for entry in cache]
    return sh.gather_cache(cache, layout, mesh, device="cpu")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="flaas-100m")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced configuration (configs.reduced)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 512-rank production mesh at 256 ranks or more")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rec = run(arch=args.arch, smoke=args.smoke, batch=args.batch,
              prompt_len=args.prompt_len, gen=args.gen,
              temperature=args.temperature, device=args.device,
              seed=args.seed, multi_pod=args.multi_pod)
    print(f"kernel launches {rec['launches']}")
    return rec


if __name__ == "__main__":
    main()

"""Serving launcher: batched prefill, then greedy or sampled decode over a
KV cache, on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve             # H100
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \
        --device cpu --smoke

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

The counterpart of ``repro``'s ``launch/serve.py`` with the same flags,
plus ``--device`` (default ``cuda``; raises without it) and ``--seed``.
The port runs on one card, so there is no ``--multi-pod`` and no mesh;
parameters are float32, as ``repro`` chooses on one device, unless
:func:`run` is given ``param_dtype="bfloat16"`` (the K/V cache, a
``rec`` block's convolution state and the memory then bfloat16 too).  Parameters
are drawn on the CPU from a generator seeded with ``--seed`` and copied to
the device, and so are the prompts: runs on the card and on the CPU serve
the same model the same prompts.  The first new token is the prefill's
argmax (as in ``repro``), then ``gen - 1`` :func:`serve_step` calls; the
cache holds ``prompt_len + gen`` positions (a recurrent block's state is
O(1), a ``local`` block's ring ``min(window, prompt_len + gen)``).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Optional

import torch

from .. import resolve_device
from ..configs import get_arch, reduced
from ..kernels import decode_attention as da
from ..kernels import flash_attention as fa
from ..kernels import rg_lru
from ..models import Transformer, forward_with_cache, init_model
from ..training import serve_step
from ..training.train_loop import param_dtype as param_dtype_of
from .inputs import cross_inputs


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


def run(arch: str = "flaas-100m", smoke: bool = False, batch: int = 4,
        prompt_len: int = 32, gen: int = 16, temperature: float = 0.0,
        device="cuda", seed: int = 0, feed: Optional[torch.Tensor] = None,
        keep_logits: bool = False,
        log: Optional[Callable[[str], None]] = print,
        model: Optional[Transformer] = None,
        memory: Optional[torch.Tensor] = None,
        enc_frames: Optional[torch.Tensor] = None,
        param_dtype: str = "float32") -> Dict:
    """Serve ``batch`` seeded prompts of ``prompt_len`` tokens and generate
    ``gen`` tokens each.  ``feed`` [batch, gen] (optional) feeds those
    tokens to the decode steps instead of the generated ones (teacher
    forcing; the generated tokens are still recorded).  ``model``
    (optional) is served instead of ``make_model(arch, seed)``, on its own
    device and configuration, so one drawn model can serve several runs;
    ``seed`` then draws only the prompts, and ``arch``, ``smoke`` and
    ``device`` must keep their defaults (a second choice raises).
    ``memory`` [batch, cross_memory_len, d_model] (a model with cross
    attention) or ``enc_frames`` [batch, cross_memory_len, d_model] (an
    encoder-decoder), on any device, are moved to the model's device and
    dtype and given to the prefill; without them it gets zeros, as
    ``repro``'s launcher gives.  ``param_dtype`` (``"float32"``, the
    one-device rule of ``repro``'s launcher, or ``"bfloat16"``) is the
    drawn model's; a ``model=`` keeps its own.  Returns ``{"cfg", "prompts", "tokens" [batch, gen], "prefill_ms",
    "step_ms" (per decode step), "tok_per_s", "launches"}`` -- the
    kernels' launches during the run -- and, with ``keep_logits``,
    ``"logits": {"prefill" [B, S, V], "decode" [B, gen - 1, V]}`` on the
    CPU."""
    if gen < 1:
        raise ValueError("gen must be at least 1")
    if model is None:
        dev = resolve_device(device)
        cfg = get_arch(arch)
        if smoke:
            cfg = reduced(cfg)
        params = make_model(cfg, seed, dev, param_dtype_of(param_dtype))
    elif (arch != "flaas-100m" or smoke or str(device) != "cuda"
          or param_dtype != "float32"):
        raise ValueError("model= serves its own configuration on its own "
                         "device in its own dtype; do not pass arch, smoke, "
                         "device or param_dtype with it")
    else:
        params, cfg, dev = model, model.cfg, model.device
    cpu_gen = torch.Generator().manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                            generator=cpu_gen, dtype=torch.int32)
    tok_gen = torch.Generator(device=dev).manual_seed(seed)
    prompts_d = prompts.to(dev)
    cross = cross_inputs(cfg, batch, dev, memory, enc_frames, params.dtype)
    total = prompt_len + gen
    if log:
        log(f"arch={cfg.name} device={dev} dtype={params.dtype} "
            f"batch={batch} prompt_len={prompt_len} gen={gen}")

    before = _launches()
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = forward_with_cache(params, prompts_d, cfg,
                                       cache_len=total, **cross)
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    out = {"prefill": logits.cpu()} if keep_logits else None
    del logits
    if log:
        log(f"prefill {batch}x{prompt_len}: {prefill_ms / 1e3:.2f}s")

    tokens, step_ms, dec_logits = [tok], [], []
    for i in range(gen - 1):
        inp = tok if feed is None else feed[:, i:i + 1].to(dev, torch.int32)
        t0 = time.perf_counter()
        tok, lg, cache = serve_step(params, inp, cache, prompt_len + i, cfg,
                                    temperature=temperature,
                                    generator=tok_gen)
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        tokens.append(tok)
        if keep_logits:
            dec_logits.append(lg[:, 0].cpu())
    decode_s = sum(step_ms) / 1e3
    tok_per_s = batch * (gen - 1) / max(decode_s, 1e-9)
    if log:
        log(f"decode {gen - 1} steps: {decode_s:.2f}s "
            f"({tok_per_s:.1f} tok/s)")
    rec = {"cfg": cfg, "prompts": prompts,
           "tokens": torch.cat(tokens, dim=1).cpu(), "prefill_ms": prefill_ms,
           "step_ms": step_ms, "tok_per_s": tok_per_s,
           "launches": {n: c - before[n] for n, c in _launches().items()}}
    if keep_logits:
        out["decode"] = (torch.stack(dec_logits, dim=1) if dec_logits else
                         torch.empty(batch, 0, cfg.vocab))
        rec["logits"] = out
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="flaas-100m")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced configuration (configs.reduced)")
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
              seed=args.seed)
    print(f"kernel launches {rec['launches']}")
    return rec


if __name__ == "__main__":
    main()

"""Serving on a mesh on spawned ranks: one process per rank, the serving
counterpart of :mod:`repro_torch.launch.sharded_train`.

    # reduced configs on 4 Gloo ranks on the CPU, mesh (data 2, model 2)
    python -m repro_torch.launch.sharded_serve --mesh 2,2 --backend gloo \\
        --device cpu --smoke
    # on the card: ranks sharing it under Gloo (every rank on cuda:0) ...
    python -m repro_torch.launch.sharded_serve --mesh 2,2 --backend gloo \\
        --device cuda --arch qwen2.5-3b
    # ... or one rank under NCCL (a (1, 1) mesh)
    python -m repro_torch.launch.sharded_serve --mesh 1,1 --backend nccl \\
        --device cuda

Each rank calls :func:`repro_torch.launch.serve.run` on the mesh; rank 0
also serves the same seeded model and prompts whole in its own process
(the one-rank yardstick) and prints how far the mesh's logits, cache and
tokens are from it.  The rank functions (:func:`serve_job`,
:func:`serve_bitwise_job`) are job kinds of
:func:`repro_torch.launch.sharded_train.jobs` too, so one spawned world
can train and serve; they import ``repro_torch`` only.
"""
from __future__ import annotations

import argparse
import contextlib
import math
import time
from typing import List, Optional

import numpy as np
import torch

from ..distributed import sharding as sh
from ..kernels import decode_attention as da
from ..kernels import flash_attention as fa
from ..kernels import rg_lru
from ..models import init_model, moe
from .mesh import launch_dtype, make_mesh

RTOL = 1e-5         # the mesh against the one-rank port, of max |value|
ROUTE_TIE = 1e-5    # k-th vs (k+1)-th router logit, of the token's max
BF16_FACTOR = 2.0   # bfloat16: within 2 d, d bfloat16's own distance
BF16_VACUOUS = 5e-2  # ... where d is under this share of max |logit|


def _reset_launches() -> None:
    for mod in (fa, da, rg_lru):
        mod.reset_launches()


@contextlib.contextmanager
def _routes(on: bool):
    """Record every ``moe.route`` call's chosen experts, router logits and
    slots (on the CPU) while a serve runs; nothing where ``on`` is
    False."""
    calls: List[tuple] = []
    if not on:
        yield calls
        return
    route = moe.route

    def record(x, router, top_k, capacity):
        r = route(x, router, top_k, capacity)
        calls.append((r.experts, r.logits, r.slot))
        return r
    moe.route = record
    try:
        yield calls
    finally:
        moe.route = route


def _cross(job, cfg, device):
    """Seeded nonzero memory (or encoder frames) [batch, cross_memory_len,
    d_model], 0.5 N(0, 1) from ``job["cross_seed"]``, drawn alike on every
    rank; none where the job has no seed or the model no cross
    attention."""
    from ..models.transformer import reads_memory
    if job.get("cross_seed") is None or not reads_memory(cfg):
        return {}
    x = 0.5 * np.random.default_rng(job["cross_seed"]).standard_normal(
        (job.get("batch", 4), cfg.cross_memory_len, cfg.d_model))
    x = torch.as_tensor(x.astype(np.float32), device=device)
    return {"enc_frames" if cfg.encoder is not None else "memory": x}


def seed_nonzero(model, seed: int) -> None:
    """What ``repro``'s init leaves zero or one, seeded so that a wrong
    cut shows: every norm scale and bias and QKV bias moved by 0.1 N(0,
    1), the ``xattn`` gates set to 0.5 and -0.7 plus 0.1 N(0, 1) (at zero
    a cross-attention block adds nothing).  Drawn on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("scale", "bias", "bq", "bk", "bv"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen).to(p.device))
            elif leaf in ("gate_x", "gate_m"):
                base = 0.5 if leaf == "gate_x" else -0.7
                p.fill_(base + 0.1 * float(torch.randn((), generator=gen)))


def _config(job):
    from ..configs import get_arch, reduced
    cfg = job["cfg"] if "cfg" in job else get_arch(job["arch"])
    return reduced(cfg) if job.get("smoke") else cfg


def _whole_model(job, cfg, device, dtype):
    """The whole seeded model of the job (its ``cfg``, dtype), drawn on
    ``device``; with ``job["nonzero"]`` its zero and one leaves seeded
    (:func:`seed_nonzero`)."""
    model = init_model(cfg, job.get("seed", 0), device=device, dtype=dtype)
    if job.get("nonzero"):
        seed_nonzero(model, job.get("seed", 0))
    return model


def serve_job(rank: int, world: int, device, job: dict) -> dict:
    """:func:`repro_torch.launch.serve.run` on ``job["mesh"]`` (shape,
    axes; one copy of it per ``prod(shape)`` ranks of the world): the
    config ``job["cfg"]`` (or ``job["arch"]``, reduced with
    ``job["smoke"]``), ``batch``, ``prompt_len``, ``gen`` (the launcher's
    defaults), ``param_dtype`` (default the launcher's rule), ``seed``;
    ``cross_seed`` seeds a nonzero memory or encoder frames, ``nonzero``
    the model's zero and one leaves (each rank then draws the whole model
    and cuts its shards from it).  Returns, on every rank: its coordinates
    and rows, its bytes (parameter shards, working parameters and cache,
    each beside the rules' count), its kernel launches, ``prefill_ms``,
    ``step_ms``, ``tok_per_s``, its peak bytes on the card over the
    serve (``peak_bytes``; None on the CPU) and the job's seconds
    (``job_s``, the comparison included); with ``job["keep"]`` rank 0's
    record of the whole batch (``tokens``, ``logits``, ``cache``,
    ``prompts``); with ``job["reference"]`` rank 0's comparison with the
    one-rank port on its device (:func:`_vs_one_rank`), ``job["rtol"]``
    its float32 bound."""
    from . import serve
    from .serve import mesh_config
    from ..training.train_loop import param_dtype as dtype_of
    t_job = time.perf_counter()
    mesh = make_mesh(*job["mesh"])
    cfg = _config(job)
    batch = job.get("batch", 4)
    whole_cfg = mesh_config(cfg, mesh, batch)[0]
    dtype = dtype_of(job.get("param_dtype") or launch_dtype())
    keep = bool(job.get("keep") or job.get("reference"))
    kw = dict(batch=batch, prompt_len=job.get("prompt_len", 32),
              gen=job.get("gen", 16), seed=job.get("seed", 0),
              **_cross(job, cfg, device))
    whole = _whole_model(job, whole_cfg, device, dtype) \
        if job.get("nonzero") else None
    _reset_launches()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with _routes(cfg.moe is not None and keep) as calls:
        if whole is None:
            rec = serve.run(whole_cfg, device=device, mesh=mesh, log=None,
                            param_dtype=str(dtype).split(".")[-1],
                            keep_logits=keep, keep_cache=keep, **kw)
        else:
            rec = serve.run(model=whole, mesh=mesh, log=None,
                            keep_logits=keep, keep_cache=keep, **kw)
    del whole
    _free(device)
    routes = _whole_routes(calls, mesh, rec["rows"], batch)
    out = {"rank": rank, "coords": rec["coords"], "rows": rec["rows"],
           "bytes": rec["bytes"], "launches": rec["launches"],
           "prefill_ms": rec["prefill_ms"], "step_ms": rec["step_ms"],
           "tok_per_s": rec["tok_per_s"], "cfg": rec["cfg"],
           "cache_shapes": rec["cache_shapes"],
           "peak_bytes": torch.cuda.max_memory_allocated() if cuda
           else None}
    if rank == 0 and job.get("keep"):
        out["run"] = {k: rec[k] for k in ("prompts", "tokens", "logits",
                                          "cache")}
    if rank == 0 and job.get("reference"):
        out.update(_vs_one_rank(job, device, rec, routes, kw, dtype))
    out["job_s"] = time.perf_counter() - t_job
    return out


def _free(device) -> None:
    """Return the card's cached blocks (the yardstick's whole model) to
    the ranks sharing it."""
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _whole_routes(calls, mesh, rows, batch) -> list:
    """Each recorded routing call of this rank's rows as the whole
    batch's: gathered over the DP axes where the batch splits (a
    collective; every rank records the same calls).  ``[(experts, logits,
    slot), ...]`` on the CPU, one entry per call."""
    lo, hi = rows
    out = []
    for experts, logits, slot in calls:
        if hi - lo < batch:
            dp = sh.dp_axes(mesh)
            experts, logits, slot = (mesh.all_gather(t, dp)
                                     for t in (experts, logits, slot))
        out.append((experts.cpu(), logits.cpu(), slot.cpu()))
    return out


def _groups(calls, n_groups: int) -> list:
    """Routing calls as one entry per dispatch group: a call that holds
    ``n_groups`` groups' tokens (the DP ranks' rows gathered) cut in
    ``n_groups``."""
    out = []
    for experts, logits, slot in calls:
        out += list(zip(experts.chunk(n_groups), logits.chunk(n_groups),
                        slot.chunk(n_groups)))
    return out


def routes_equal(got, want, k: int) -> dict:
    """Each dispatch group's chosen experts equal (``got`` against
    ``want``), but tokens whose k-th and (k+1)-th router logits (the
    yardstick's) lie within ROUTE_TIE of the token's largest |logit|
    (near-ties, counted); each group's slots -- which assignments an
    expert keeps and which it drops -- equal wherever the group has no
    near-tie.  Raises ``AssertionError`` otherwise; returns the counts."""
    assert len(got) == len(want), (len(got), len(want))
    ties = tokens = dropped = tie_groups = 0
    for (eg, _, sg), (ew, lw, sw) in zip(got, want):
        s = torch.sort(lw.double(), dim=-1, descending=True).values
        tie = (s[:, k - 1] - s[:, k]) <= ROUTE_TIE * lw.abs().amax(-1)
        assert torch.equal(eg[~tie], ew[~tie]), "chosen experts differ"
        if bool(tie.any()):
            tie_groups += 1
        else:
            assert torch.equal(sg, sw), "kept / dropped assignments differ"
        ties += int(tie.sum())
        tokens += tie.numel()
        dropped += int((sw < 0).sum())
    return {"groups": len(want), "tokens": tokens, "near_ties": ties,
            "groups_with_ties": tie_groups, "dropped": dropped}


def _top2_gap(logits):
    top = torch.topk(logits.double(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def compare_runs(got: dict, want: dict, bound: float,
                 ref_cache=None, rtol: float = RTOL) -> dict:
    """A mesh serve ``got`` against the yardstick ``want`` (teacher-forced
    with ``got``'s tokens, so both saw the same inputs): prefill and
    decode logits within ``bound``; every cache entry, after the
    prefill and after the last step, within ``rtol`` of its largest
    |value| or, with ``ref_cache`` (the yardstick's float32 run's),
    within BF16_FACTOR times its distance from that; the tokens equal
    wherever the yardstick's top-two gap exceeds ``bound``.  Raises
    ``AssertionError`` otherwise; returns the largest errors (the cache's
    as a share of its bound), the largest |value|s and the near-ties."""
    assert torch.equal(got["prompts"], want["prompts"])
    errs, tops = {}, {}
    for part in ("prefill", "decode"):
        g, w = got["logits"][part], want["logits"][part]
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), part
        errs[part] = float((g.double() - w.double()).abs().max()) \
            if g.numel() else 0.0
        tops[part] = float(w.abs().max()) if w.numel() else 0.0
        assert errs[part] <= bound, (part, errs[part], bound)
    cache_err = cache_top = share = 0.0
    for when in ("prefill", "final"):
        for i, (gb, wb) in enumerate(zip(got["cache"][when],
                                         want["cache"][when])):
            assert set(gb) == set(wb), (sorted(gb), sorted(wb))
            for n in wb:
                assert gb[n].shape == wb[n].shape, (n, gb[n].shape,
                                                    wb[n].shape)
                assert gb[n].dtype == wb[n].dtype, n
                e = float((gb[n].double() - wb[n].double()).abs().max())
                t = float(wb[n].abs().max())
                lim = rtol * t if ref_cache is None else BF16_FACTOR * float(
                    (wb[n].double() - ref_cache[when][i][n].double())
                    .abs().max())
                assert e <= lim, (when, i, n, e, lim)
                cache_err, cache_top = max(cache_err, e), max(cache_top, t)
                share = max(share, e / lim if lim else 0.0)
    errs["cache"], tops["cache"] = cache_err, cache_top
    errs["cache_share"] = share
    chooser = torch.cat([want["logits"]["prefill"][:, -1:],
                         want["logits"]["decode"]], dim=1)
    gap = _top2_gap(chooser)
    near = gap <= bound
    same = got["tokens"] == want["tokens"]
    assert bool((same | near).all()), "greedy tokens differ past near-ties"
    return {"errs": errs, "tops": tops, "bound": bound,
            "near_ties": int(near.sum()), "tokens_differ": int((~same).sum())}


def _vs_one_rank(job, device, rec, routes, kw, dtype) -> dict:
    """Rank 0: the same seeded whole model served in this process, on
    ``device``, teacher-forced with the mesh's tokens, against the mesh's
    record ``rec``: logits and every cache entry within ``job["rtol"]``
    (default RTOL) of each part's largest |value| in float32, within
    BF16_FACTOR d in bfloat16 (d the largest distance of the yardstick's
    bfloat16 logits from its float32 ones, the same model in float32,
    under BF16_VACUOUS of their largest |logit|); tokens past near-ties;
    a MoE model's routing (:func:`routes_equal`)."""
    from . import serve
    cfg = rec["cfg"]
    model = _whole_model(job, cfg, device, dtype)
    with _routes(cfg.moe is not None) as calls:
        want = serve.run(model=model, feed=rec["tokens"], log=None,
                         keep_logits=True, keep_cache=True, **kw)
    del model
    _free(device)
    out = {}
    if dtype == torch.float32:
        top = max(float(want["logits"][p].abs().max())
                  for p in ("prefill", "decode") if want["logits"][p].numel())
        rtol = job.get("rtol", RTOL)
        cmp = compare_runs(rec, want, rtol * top, rtol=rtol)
    else:
        f32 = serve.run(model=_whole_model(job, cfg, device, torch.float32),
                        feed=rec["tokens"], log=None, keep_logits=True,
                        keep_cache=True, **kw)
        d = max(float((want["logits"][p].double() - f32["logits"][p]
                       .double()).abs().max())
                for p in ("prefill", "decode") if f32["logits"][p].numel())
        scale = max(float(f32["logits"][p].abs().max())
                    for p in ("prefill", "decode") if f32["logits"][p].numel())
        assert 0 < d < BF16_VACUOUS * scale, (
            f"{cfg.name}: bfloat16's own distance from float32 {d} of "
            f"max|logit| {scale} bounds nothing")
        out["d"], out["d_scale"] = d, scale
        _free(device)
        cmp = compare_runs(rec, want, BF16_FACTOR * d, f32["cache"])
    out["vs_one_rank"] = cmp
    out["one_rank"] = {k: want[k] for k in ("prefill_ms", "step_ms",
                                             "tok_per_s", "launches")}
    if cfg.moe is not None:
        g = cfg.moe_dispatch_groups
        split = rec["rows"][1] - rec["rows"][0] < rec["tokens"].shape[0]
        out["routes"] = routes_equal(_groups(routes, g if split else 1),
                                     _groups(calls, 1), cfg.moe.top_k)
    return out


def serve_bitwise_job(rank: int, world: int, device, job: dict) -> dict:
    """The serve on a (1, 1) mesh against the unsharded serve of the same
    seeded model (drawn whole on ``device``) in this process: whether the
    tokens, logits and cache are bitwise equal."""
    from . import serve
    cfg = _config(job)
    mesh = make_mesh((1, 1), ("data", "model"))
    dtype = torch.float32 if job.get("param_dtype", "float32") == \
        "float32" else torch.bfloat16
    kw = dict(batch=job.get("batch", 4), prompt_len=job.get("prompt_len", 32),
              gen=job.get("gen", 16), seed=job.get("seed", 0),
              keep_logits=True, keep_cache=True, log=None)
    a = serve.run(cfg, device=device, mesh=mesh,
                  param_dtype=str(dtype).split(".")[-1], **kw)
    b = serve.run(model=init_model(cfg, job.get("seed", 0), device=device,
                                   dtype=dtype), **kw)
    same = torch.equal(a["tokens"], b["tokens"]) and all(
        torch.equal(a["logits"][p], b["logits"][p])
        for p in ("prefill", "decode"))
    for when in ("prefill", "final"):
        for x, y in zip(a["cache"][when], b["cache"][when]):
            same &= all(torch.equal(x[n], y[n]) for n in y)
    return {"bitwise": bool(same), "backend": job.get("backend"),
            "launches": a["launches"], "tokens": a["tokens"].shape}


# ------------------------------------------------------------------- CLI
SMOKE_ARCHS = ("qwen2.5-3b", "recurrentgemma-2b", "llama-3.2-vision-11b",
               "whisper-medium", "mixtral-8x22b", "xlstm-125m")


def _demo(rank, world, device, args) -> Optional[list]:
    shape = tuple(int(s) for s in args.mesh.split(","))
    axes = ("pod", "data", "model")[-len(shape):]
    archs = SMOKE_ARCHS if args.arch == "all" else (args.arch,)
    if device == "cpu" or torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    out = []
    for arch in archs:
        res = serve_job(rank, world, device, dict(
            arch=arch, smoke=args.smoke, mesh=(shape, axes),
            batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
            param_dtype=args.param_dtype, cross_seed=1, nonzero=args.smoke,
            reference=True))
        out.append((arch, res))
    return out if rank == 0 else None


def main(argv=None) -> int:
    from .sharded_service import spawn
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--mesh", default="2,2",
                   help="(data, model) or (pod, data, model) sizes")
    p.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--arch", default=None,
                   help="one config (default: with --smoke, one of each "
                        "block kind; else flaas-100m)")
    p.add_argument("--smoke", action="store_true", help="reduced configs")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--param-dtype", default="float32",
                   help="float32 (held within 1e-5 of one rank) or bfloat16 "
                        "(within 2 d; MoE and xLSTM's bfloat16 distance from "
                        "float32 is too large to bound them)")
    args = p.parse_args(argv)
    if args.arch is None:
        args.arch = "all" if args.smoke else "flaas-100m"
    from .. import resolve_device
    resolve_device(args.device)
    n = math.prod(int(s) for s in args.mesh.split(","))
    for arch, r in spawn(_demo, n, backend=args.backend, device=args.device,
                         args=(args,))[0]:
        c = r["vs_one_rank"]
        bound = "2 d" if "d" in r else f"{RTOL} x max|value|"
        print(f"{arch}: mesh {args.mesh} against one rank: prefill "
              f"{c['errs']['prefill']:.3e}, decode {c['errs']['decode']:.3e}, "
              f"cache {c['errs']['cache']:.3e} (bound {bound}); "
              f"{c['tokens_differ']} tokens differ at {c['near_ties']} "
              f"near-ties; rank 0 bytes {r['bytes']}; launches "
              f"{r['launches']}"
              + (f"; routes {r['routes']}" if "routes" in r else ""))
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

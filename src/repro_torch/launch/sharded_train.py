"""The sharded training step and GPipe ``pipeline_apply`` on spawned
ranks: one process per rank of a mesh.

    # the launcher's sharded step, 4 Gloo ranks on the CPU, mesh (2, 2)
    python -m repro_torch.launch.sharded_train --mesh 2,2 --backend gloo \\
        --device cpu --smoke --steps 2
    # on the card: ranks sharing it under Gloo (every rank on cuda:0) ...
    python -m repro_torch.launch.sharded_train --mesh 2,2 --backend gloo \\
        --device cuda --steps 3
    # ... or one rank under NCCL (a (1, 1) mesh)
    python -m repro_torch.launch.sharded_train --mesh 1,1 --backend nccl \\
        --device cuda --steps 3
    # pipeline_apply over flaas-100m's blocks as 4 stages on 'pod'
    python -m repro_torch.launch.sharded_train --pipeline 4 --backend gloo \\
        --device cpu --smoke

Rank 0 prints each step's metrics (and, with ``--pipeline``, the
largest difference from the sequential forward).  The rank functions
here (:func:`jobs` over :func:`train_job`, :func:`launcher_job`,
:func:`pipeline_job`, and the serving jobs of
:mod:`repro_torch.launch.sharded_serve`) run under
:func:`repro_torch.launch.sharded_service.spawn` and return
what their callers compare: the tests against the one-rank port and
``repro``, ``chip_smoke.py`` against the one-process card run.  They
import ``repro_torch`` only.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from ..distributed import sharding as sh
from ..distributed.pipeline_parallel import pipeline_apply
from ..kernels import dp_clip_noise, rg_lru
from ..models.transformer import apply_block_train
from ..training import make_state, train_step
from ..training.train_loop import (_grads_with_loss, gather_state,
                                   make_loss_fn, shard_state,
                                   sharded_gradients, sharded_opt_init,
                                   state_layout, step_generator)
from .mesh import make_mesh
from .sharded_serve import serve_bitwise_job, serve_job


def _launches() -> dict:
    return {**dp_clip_noise.LAUNCHES, **rg_lru.LAUNCHES,
            **rg_lru.BWD_LAUNCHES}


def _reset_launches() -> None:
    dp_clip_noise.reset_launches()
    rg_lru.reset_launches()


def _host_state(full) -> dict:
    """A gathered state as host tensors: ``params`` by name, the
    optimizer's per-leaf trees, ``step``."""
    out = {"params": {n: p.detach().cpu()
                      for n, p in full["params"].named_parameters()},
           "step": int(full["step"])}
    for k, v in full["opt"].items():
        out[k] = {n: (t.cpu() if isinstance(t, torch.Tensor) else
                      {s: x.cpu() for s, x in t.items()})
                  for n, t in v.items()} if isinstance(v, dict) else \
            v.cpu()
    return out


def _nbytes(state) -> int:
    """Bytes of a state's parameters and optimizer leaves (as allocated)."""
    n = sum(f.numel() * f.element_size()
            for f in state["params"].flats.values())
    for v in state["opt"].values():
        for t in (v.values() if isinstance(v, dict) else [v]):
            for x in (t.values() if isinstance(t, dict) else [t]):
                n += x.numel() * x.element_size()
    return n


def _rule_bytes(cfg, tcfg, mesh) -> int:
    """The same count from the rules: every leaf's local shape under its
    spec, times its dtype's size."""
    specs = state_layout(cfg, tcfg, mesh)
    full = make_state(0, cfg, tcfg, device="meta")
    n = sum(math.prod(sh.local_shape(p.shape, specs["params"][k], mesh)) *
            p.element_size() for k, p in full["params"].named_parameters())
    for key, v in full["opt"].items():
        if not isinstance(v, dict):
            n += v.numel() * v.element_size()
            continue
        for k, t in v.items():
            for s, x in (t.items() if isinstance(t, dict) else [(None, t)]):
                sp = specs["opt"][key][k] if s is None else \
                    specs["opt"][key][k][s]
                n += math.prod(sh.local_shape(x.shape, sp, mesh)) * \
                    x.element_size()
    return n


@torch.no_grad()
def _job_state(job, device, mesh=None):
    """The job's initial state, this rank's shards under ``mesh``:
    ``make_state``'s, or with the parameters ``job["params"]`` ({name:
    full array}) and a fresh optimizer state."""
    cfg, tcfg = job["cfg"], job["tcfg"]
    state = make_state(job.get("seed", 0), cfg, tcfg, device=device,
                       mesh=mesh)
    if job.get("params") is not None:
        specs = None if mesh is None else state_layout(cfg, tcfg, mesh)
        for n, p in state["params"].named_parameters():
            full = torch.as_tensor(job["params"][n])
            p.copy_(full if mesh is None else
                    sh.shard(full, specs["params"][n], mesh))
        state["opt"] = tcfg.make_optimizer().init(state["params"]) \
            if mesh is None else sharded_opt_init(state["params"], cfg, tcfg,
                                                  mesh)
    return state


def _grads(state, batch, cfg, tcfg, device, mesh=None):
    """The step's gradients before the optimizer, without noise (every
    other part of the step's DP), and its metrics: this rank's shards
    under ``mesh``, else the one-rank port's."""
    clean = dataclasses.replace(tcfg, dp=dataclasses.replace(
        tcfg.dp, noise_multiplier=0.0))
    gen = step_generator(state["seed"], int(state["step"]), device)
    if mesh is not None:
        return sharded_gradients(state, batch, cfg, clean, mesh, gen)
    (g, m), loss = _grads_with_loss(make_loss_fn(cfg), state["params"],
                                    batch, gen, clean)
    return g, {**m, "loss_mean": loss}


def train_job(rank: int, world: int, device, job: dict) -> dict:
    """Steps of the sharded :func:`train_step` on ``job["mesh"]`` (shape,
    axes: one copy of it per ``prod(shape)`` ranks of the world) from the
    job's state, over ``job["batches"]`` (global numpy batches;
    ``job["steps"]`` of them, default all).  Returns, on every rank: its
    coordinates, its bytes of parameters and
    optimizer state beside the rules' count, its kernel launches in the
    gradient pass and over the steps, each step's metrics and ms, the
    job's seconds on this rank (``job_s``, the comparison included); with
    ``job["grads"]`` the gradients before the first step's optimizer
    (noise off) gathered on rank 0; on rank 0 the parameters gathered
    after ``job["gather_after"]`` steps (default: the last; none with
    ``job["gather"]`` False), and with
    ``job["reference"]`` rank 0's comparison of all that with the
    one-rank port's run of the same job on its device
    (:func:`_vs_one_rank`) in place of the tensors."""
    t_job = time.perf_counter()
    cfg, tcfg = job["cfg"], job["tcfg"]
    mesh = make_mesh(*job["mesh"])
    state = _job_state(job, device, mesh)
    specs = state_layout(cfg, tcfg, mesh)
    batches = [{k: torch.as_tensor(v, device=device) for k, v in b.items()}
               for b in job["batches"]]
    steps = job.get("steps", len(batches))
    at = job.get("gather_after", steps)
    out = {"rank": rank, "coords": dict(mesh.coords), "bytes": _nbytes(state),
           "rule_bytes": _rule_bytes(cfg, tcfg, mesh), "records": [],
           "local_shapes": {n: tuple(p.shape) for n, p in
                            state["params"].named_parameters()}}
    if job.get("grads"):
        _reset_launches()
        g, m = _grads(state, batches[0], cfg, tcfg, device, mesh)
        out["launches_grads"] = _launches()
        g = dict(zip(g, sh.gather_many(list(g.values()), [
            specs["params"][n] for n in g], mesh)))
        # rank 0 compares on its device with a reference, else returns
        out["grads"] = None if rank else g if job.get("reference") else \
            {n: t.cpu() for n, t in g.items()}
        out["grad_metrics"] = {k: float(v) for k, v in m.items()}
        del g
    _reset_launches()
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = train_step(state, batches[i], cfg, tcfg, mesh)
        rec = {k: float(v) for k, v in m.items()}
        rec["ms"] = (time.perf_counter() - t0) * 1e3
        out["records"].append(rec)
        if i + 1 == at and job.get("gather", True):
            names = list(out["local_shapes"])
            full = sh.gather_many(
                [p.detach() for p in state["params"].parameters()],
                [specs["params"][n] for n in names], mesh)
            out["state"] = {"params": {n: t.cpu() for n, t in
                                       zip(names, full)}} \
                if rank == 0 else None
            del full
    out["launches"] = _launches()
    del state
    if job.get("reference") and rank == 0:
        out.update(_vs_one_rank(job, device, out))
        out.pop("grads", None)
        out.pop("state", None)
    out["job_s"] = time.perf_counter() - t_job
    return out


def _vs_one_rank(job, device, got) -> dict:
    """The one-rank port's run of ``job`` on ``device`` against the
    sharded run's results ``got``: the gradients' largest error over
    each leaf's largest |g| and over the largest |g| of all, each step's
    loss and ``grad_norm_mean`` relative error, the parameters' largest
    error after ``gather_after`` steps."""
    cfg, tcfg = job["cfg"], job["tcfg"]
    state = _job_state(job, device)
    batches = [{k: torch.as_tensor(v, device=device) for k, v in b.items()}
               for b in job["batches"]]
    res = {}
    if job.get("grads"):
        g, m = _grads(state, batches[0], cfg, tcfg, device)
        per_leaf, err, top = 0.0, 0.0, 0.0
        for n, want in g.items():
            d = float((got["grads"][n].to(device) - want).abs().max())
            scale = float(want.abs().max())
            per_leaf = max(per_leaf, d / max(scale, 1e-30))
            err, top = max(err, d), max(top, scale)
        res["grad_err_per_leaf"] = per_leaf
        res["grad_err"], res["grad_max"] = err, top
        res["grad_metrics_one_rank"] = {k: float(v) for k, v in m.items()}
        del g
    steps = job.get("steps", len(batches))
    at = job.get("gather_after", steps)
    rel = {"loss": 0.0, "grad_norm_mean": 0.0}
    for i in range(steps):
        state, m = train_step(state, batches[i], cfg, tcfg)
        for k in rel:
            a, b = got["records"][i][k], float(m[k])
            rel[k] = max(rel[k], abs(a - b) / max(abs(b), 1e-30))
        if i + 1 == at and "state" in got:
            res["param_err"] = max(
                float((got["state"]["params"][n].to(device) - p.detach())
                      .abs().max())
                for n, p in state["params"].named_parameters())
    res["metric_rel_err"] = rel
    return res


def launcher_job(rank: int, world: int, device, job: dict) -> dict:
    """:func:`repro_torch.launch.train.run` on ``job["mesh"]`` with
    ``job["run"]``'s keyword arguments; the records and, gathered, the
    final state (rank 0)."""
    from . import train as launcher
    mesh = make_mesh(*job["mesh"])
    res = launcher.run(device=device, mesh=mesh, log=None, **job["run"])
    full = gather_state(res["state"], res["cfg"], res["tcfg"], mesh,
                        device="cpu")
    recs = [{k: v for k, v in r.items() if k != "wall_s"}
            for r in res["records"]]
    return {"records": recs, "resumed_from": res["resumed_from"],
            "checkpoints": res["checkpoints"],
            "state": _host_state(full) if rank == 0 else None}


# ------------------------------------------------------------- pipelines
def tanh_stage(w, h):
    """``repro``'s test stage: tanh(h @ w)."""
    return torch.tanh(h @ w)


def blocks_stage(params, h):
    """A stage of whole blocks: ``params`` is ``(model, cfg, [block
    indices])``; the blocks' training forward over ``h`` [B, S, D]."""
    model, cfg, idx = params
    pos = torch.arange(h.shape[1], device=h.device)
    for i in idx:
        blk = model.blocks[i]
        h = apply_block_train(h, blk, blk.kind, cfg, positions=pos)
    return h


def pipeline_input(shape, seed: int = 0) -> np.ndarray:
    """A seeded pipeline input: 0.1 N(0, 1), float32, of ``shape``."""
    return (0.1 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def pipeline_job(rank: int, world: int, device, job: dict) -> dict:
    """``pipeline_apply`` on a ``(n_stages,)`` 'pod' mesh: ``job["w"]``
    [n_stages, d, d] through :func:`tanh_stage`, or with ``job["cfg"]``
    a seeded model's blocks split into ``n_stages`` contiguous stages,
    over ``job["x"]`` [n_micro, ...] (or :func:`pipeline_input` of
    ``job["x_shape"]``, drawn on each rank: a spawned rank's arguments
    pass through a pipe, and one over its buffer holds up the start of
    the next rank until this one has imported its modules).  Returns the
    outputs and ms; with
    ``job["reference"]`` rank 0 returns instead the largest difference
    from :func:`sequential_blocks` on its device and the largest
    |output|."""
    n = job["n_stages"]
    mesh = make_mesh((n,), ("pod",))
    x_np = job["x"] if "x" in job else pipeline_input(job["x_shape"])
    x = torch.as_tensor(x_np, device=device)
    stage = mesh.coords["pod"]
    if "w" in job:
        fn, params = tanh_stage, torch.as_tensor(job["w"][stage],
                                                 device=device)
    else:
        from ..models import init_model
        cfg = job["cfg"]
        model = init_model(cfg, job.get("seed", 0), device=device)
        per = cfg.n_layers // n
        fn, params = blocks_stage, (model, cfg,
                                    range(stage * per, (stage + 1) * per))
    with torch.no_grad():
        t0 = time.perf_counter()
        y = pipeline_apply(fn, params, x, mesh, axis="pod")
        y = y.cpu()
        ms = (time.perf_counter() - t0) * 1e3
    if not job.get("reference"):
        return {"y": y, "ms": ms}
    del params
    if rank:
        return {"ms": ms}
    want = sequential_blocks(job["cfg"], x_np, job.get("seed", 0),
                             device)
    return {"ms": ms, "err": float((y - want).abs().max()),
            "y_max": float(want.abs().max()), "shape": tuple(y.shape)}


def sequential_blocks(cfg, x, seed=0, device="cpu") -> torch.Tensor:
    """The blocks of ``init_model(cfg, seed)`` one after another over each
    microbatch of ``x`` [n_micro, B, S, D]: the pipeline's reference."""
    from ..models import init_model
    model = init_model(cfg, seed, device=device)
    with torch.no_grad():
        return torch.stack([blocks_stage(
            (model, cfg, range(cfg.n_layers)), torch.as_tensor(
                xi, device=device)) for xi in x]).cpu()


def rule_job(rank: int, world: int, device, job: dict) -> dict:
    """``repro``'s launcher rule in this world: the mesh and dtype the
    launcher picks."""
    from .mesh import launch_dtype, launch_mesh
    return {"mesh": launch_mesh(job.get("multi_pod", False)).shape,
            "param_dtype": launch_dtype()}


def bitwise_job(rank: int, world: int, device, job: dict) -> dict:
    """The sharded path on a (1, 1) mesh against the unsharded step in
    this process, ``job["steps"]`` steps of ``job``'s config over its
    batches: whether metrics, parameters and optimizer state are
    bitwise equal, and the largest parameter difference."""
    cfg, tcfg = job["cfg"], job["tcfg"]
    mesh = make_mesh((1, 1), ("data", "model"))
    a = _job_state(job, device)
    b = _job_state(job, device, mesh)
    same = True
    for batch in job["batches"]:
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        a, ma = train_step(a, batch, cfg, tcfg)
        b, mb = train_step(b, batch, cfg, tcfg, mesh)
        same &= all(torch.equal(ma[k], mb[k]) for k in ma)
    pa = {n: p.detach() for n, p in a["params"].named_parameters()}
    pb = {n: p.detach() for n, p in b["params"].named_parameters()}
    same &= all(torch.equal(pa[n], pb[n]) for n in pa)
    for key, v in a["opt"].items():
        for n, t in (v.items() if isinstance(v, dict) else [(None, v)]):
            u = b["opt"][key] if n is None else b["opt"][key][n]
            same &= torch.equal(t, u)
    return {"bitwise": bool(same), "backend": job.get("backend"),
            "param_err": max(float((pa[n] - pb[n]).abs().max())
                             for n in pa)}


def init_job(rank: int, world: int, device, job: dict) -> dict:
    """``make_state`` under ``job["mesh"]`` (drawn into the shards)
    against :func:`shard_state` of the full ``make_state``: whether
    every parameter and optimizer leaf is bitwise equal."""
    cfg, tcfg = job["cfg"], job["tcfg"]
    mesh = make_mesh(*job["mesh"])
    a = make_state(0, cfg, tcfg, device=device, mesh=mesh)
    b = shard_state(make_state(0, cfg, tcfg, device=device), cfg, mesh)
    same = all(torch.equal(a["params"].flats[d], b["params"].flats[d])
               for d in b["params"].flats)
    for key, v in b["opt"].items():
        for n, t in (v.items() if isinstance(v, dict) else [(None, v)]):
            u = a["opt"][key] if n is None else a["opt"][key][n]
            for x, y in zip(t.values() if isinstance(t, dict) else [t],
                            u.values() if isinstance(u, dict) else [u]):
                same &= x.shape == y.shape and torch.equal(x, y)
    return {"bitwise": bool(same), "keys": sorted(a["opt"])}


def mark_job(rank: int, world: int, device, job: dict) -> dict:
    """Leave the file ``job["path"]``: worlds sharing one card order
    their heavy jobs by it (:func:`await_job`)."""
    with open(job["path"], "a"):
        pass
    return {}


def await_job(rank: int, world: int, device, job: dict) -> dict:
    """Wait until the file ``job["path"]`` exists (another world's
    :func:`mark_job`), at most ``job["timeout"]`` seconds (default 600):
    the seconds waited."""
    import os
    t0 = time.perf_counter()
    while not os.path.exists(job["path"]):
        if time.perf_counter() - t0 > job.get("timeout", 600):
            raise TimeoutError(f"no {job['path']} after "
                               f"{job.get('timeout', 600)} s")
        time.sleep(0.1)
    return {"waited_s": time.perf_counter() - t0}


KINDS = {"train": train_job, "init": init_job, "launcher": launcher_job,
         "pipeline": pipeline_job, "rule": rule_job, "bitwise": bitwise_job,
         "serve": serve_job, "serve_bitwise": serve_bitwise_job,
         "mark": mark_job, "await": await_job}


def jobs(rank: int, world: int, device, todo: list) -> list:
    """Each ``(kind, job)`` of ``todo`` in turn (:data:`KINDS`), in one
    world: the results in order; on the card each job's cached blocks
    go back before the next.  Ranks on the CPU take one intra-op
    thread each: the models here are small and a world's ranks share the
    host's cores (4 ranks of 8 threads ran the CPU tests' cases 3x
    slower)."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    out = []
    for kind, job in todo:
        out.append(KINDS[kind](rank, world, device, job))
        if torch.device(device).type == "cuda":   # to the next job's ranks
            torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------- CLI
def _demo_train(rank, world, device, args) -> Optional[list]:
    from ..configs import get_arch, reduced
    shape = tuple(int(s) for s in args.mesh.split(","))
    axes = ("pod", "data", "model")[-len(shape):]
    res = launcher_job(rank, world, device, {
        "mesh": (shape, axes),
        "run": dict(arch=args.arch, steps=args.steps, batch=args.batch,
                    seq=args.seq, smoke=args.smoke, ckpt=args.ckpt,
                    ckpt_every=args.steps)})
    return res["records"] if rank == 0 else None


def _demo_pipeline(rank, world, device, args) -> Optional[float]:
    from ..configs import get_arch, reduced
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = reduced(cfg, n_layers=2 * args.pipeline)
    shape = (4, 2, args.seq, cfg.d_model)
    got = pipeline_job(rank, world, device, {"n_stages": args.pipeline,
                                             "cfg": cfg, "x_shape": shape})
    if rank:
        return None
    want = sequential_blocks(cfg, pipeline_input(shape), device=device)
    return float((got["y"] - want).abs().max())


def main(argv=None) -> int:
    import tempfile
    from .sharded_service import spawn
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--mesh", default="2,2",
                   help="(data, model) or (pod, data, model) sizes")
    p.add_argument("--pipeline", type=int, default=0,
                   help="stages of a pipeline_apply demo instead")
    p.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    p.add_argument("--device", required=True)
    p.add_argument("--arch", default="flaas-100m")
    p.add_argument("--smoke", action="store_true", help="reduced config")
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    args = p.parse_args(argv)
    if args.pipeline:
        err = spawn(_demo_pipeline, args.pipeline, backend=args.backend,
                    device=args.device, args=(args,))[0]
        print(f"pipeline_apply, {args.pipeline} stages: max |pipeline - "
              f"sequential| = {err:.3e}")
        return 0
    args.ckpt = tempfile.mkdtemp(prefix="sharded_train_")
    n = math.prod(int(s) for s in args.mesh.split(","))
    for rec in spawn(_demo_train, n, backend=args.backend,
                     device=args.device, args=(args,))[0]:
        print({k: round(v, 6) if isinstance(v, float) else v
               for k, v in rec.items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

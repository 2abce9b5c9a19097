"""Launcher for the sharded service plane: one process per block stripe.

    # S ranks spawned here (torch.multiprocessing), Gloo on the CPU
    python -m repro_torch.launch.sharded_service --shards 2 --backend gloo \\
        --device cpu --smoke
    # on the card: NCCL at one rank a card, or Gloo for several ranks
    # sharing one card (every rank then takes cuda:0)
    python -m repro_torch.launch.sharded_service --shards 1 --backend nccl \\
        --device cuda
    # under torchrun the process group comes from its environment
    torchrun --nproc-per-node 2 -m repro_torch.launch.sharded_service \\
        --shards 2 --backend nccl --device cuda

The counterpart of ``examples/sharded_service.py`` and of
``examples/elastic_restart.py``'s three acts.  Every rank runs the
unsharded control service and the sharded one over the same trace and
prints (rank 0) the parity table; then the acts: a service runs half its
ticks and checkpoints (act 1), a fresh service restores and finishes
bitwise (act 2), and the checkpoint hands off between one stripe and
``--shards`` stripes and back, within 1e-5 of the control (act 3).

:func:`spawn` runs any rank function under a fresh process group with a
time limit, joins every rank and returns their results;
:func:`service_job` is the rank function that drives one sharded service
run (restore, ticks, save) and reports its rows, summary and state.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import pickle
import shutil
import socket
import sys
import tempfile
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.blockaxis import COLLECTIVES, reset_collectives
from ..core.registry import SCHEDULER_NAMES
from ..core.scheduler import SchedulerConfig

SMOKE_SIZE = dict(n_devices=4, pipelines_per_analyst=6)
SMOKE_SERVICE = dict(analyst_slots=3, pipeline_slots=6, block_slots=80,
                     chunk_ticks=4, admit_batch=8, max_pending=64)
# repro/service/load.py's defaults (paper_default, 200 blocks a tick)
FULL_SERVICE = dict(analyst_slots=8, pipeline_slots=25, block_slots=4096,
                    chunk_ticks=8, admit_batch=32, max_pending=1024)
DEMO_TIMEOUT = 1800.0          # seconds a collective of the demo may wait


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device(device, rank: int, world: int) -> torch.device:
    """Rank ``rank``'s device: with as many cards as ranks, rank r takes
    ``cuda:r``; with fewer, every rank takes ``cuda:0``.  A CPU device is
    every rank's."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank if torch.cuda.device_count() >= world
                        else 0)


def init_rank(rank: int, world: int, backend: str, device,
              init_method: Optional[str] = None,
              timeout: float = 600.0) -> torch.device:
    """Join the process group (``init_method`` None: from torchrun's
    environment) and return this rank's device.  A collective that waits
    longer than ``timeout`` seconds raises instead of hanging."""
    import torch.distributed as dist
    dev = rank_device(device, rank, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))
    return dev


def _entry(rank, fn, world, backend, device, init_method, timeout, args,
           out_dir):
    import torch.distributed as dist
    dev = init_rank(rank, world, backend, device, init_method, timeout)
    try:
        result = fn(rank, world, dev, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, shards: int, *, backend: str, device, args=(),
          timeout: float = 600.0) -> List:
    """Run ``fn(rank, world, device, *args)`` on ``shards`` new processes
    joined in one process group (``backend`` over ``tcp://localhost``);
    returns every rank's result in rank order.  ``fn`` and its results
    must pickle.  Raises a rank's exception, or ``TimeoutError`` after
    ``timeout`` seconds, having stopped every rank either way."""
    import torch.multiprocessing as mp
    out_dir = tempfile.mkdtemp(prefix="sharded_service_")
    init = f"tcp://localhost:{free_port()}"
    ctx = mp.start_processes(
        _entry, args=(fn, shards, backend, device, init, timeout, args,
                      out_dir),
        nprocs=shards, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout + 60.0
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{shards} ranks of {getattr(fn, '__name__', fn)} still "
                    f"running after {timeout + 60.0:.0f} s")
        out = []
        for r in range(shards):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(out_dir, ignore_errors=True)


def make_service(job: dict, device, *, sharded: bool = True, group=None):
    """The service a job describes: ``scheduler``, ``service``
    (ServiceConfig fields), ``sched`` (SchedulerConfig fields) and
    ``trace`` (make_trace arguments: ``scenario``, ``pattern``, ``seed``
    and sizes)."""
    from ..service import FlaasService, ServiceConfig, make_trace
    from ..shard import ShardedFlaasService
    tr = dict(job.get("trace", {}))
    trace = make_trace(tr.pop("scenario", "paper_default"),
                       tr.pop("pattern", "poisson"), seed=tr.pop("seed", 0),
                       **tr)
    cfg = ServiceConfig(scheduler=job["scheduler"],
                        sched=SchedulerConfig(**job.get("sched", {})),
                        **job["service"])
    if not sharded:
        return FlaasService(cfg, trace, device=device)
    return ShardedFlaasService(cfg, trace, group=group, device=device)


def capture_selections(service) -> list:
    """Keep every chunk's ``[T, M, N]`` selections (``run_chunk`` folds
    them into telemetry and drops them); returns the list it fills."""
    kept = []
    step_of = service._compiled_step

    def compiled(n_ticks, mode):
        step = step_of(n_ticks, mode)

        def run(state, ops, tick0):
            final, ys = step(state, ops, tick0)
            kept.append(ys["selected"].cpu().numpy())
            return final, ys
        return run

    service._compiled_step = compiled
    return kept


def _host_state(state) -> dict:
    return {f.name: getattr(state, f.name).cpu().numpy()
            for f in dataclasses.fields(state)}


def service_job(rank: int, world: int, device, job: dict,
                sharded: bool = True) -> Optional[dict]:
    """One service run on this rank: build it, restore ``job["restore"]``
    (a checkpoint directory) if given, run to tick ``job["ticks"]``, then
    save into ``job["save"]`` if given (``job["async_save"]``: async, then
    ``wait()``).  Rank 0 returns the per-tick rows (with ``selected``),
    the summary, the whole-ring final state as numpy, ticks/s (host clock,
    synchronised), collectives and budget-kernel launches per tick; other
    ranks return None."""
    from ..checkpoint import CheckpointManager
    from ..kernels import budget_alloc as ba
    svc = make_service(job, device, sharded=sharded)
    if job.get("restore"):
        svc.load_checkpoint(CheckpointManager(job["restore"]))
    sel = capture_selections(svc)
    tick0 = svc.tick
    parts = []
    cuda = svc.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(svc.device)
    reset_collectives()
    ba.reset_launches()
    t0 = time.perf_counter()
    while svc.tick < job["ticks"]:
        parts.append(svc.run_chunk(min(svc.cfg.chunk_ticks,
                                       job["ticks"] - svc.tick)))
    if cuda:
        torch.cuda.synchronize(svc.device)
    wall = time.perf_counter() - t0
    n = svc.tick - tick0
    collectives = dict(COLLECTIVES)
    launches = dict(ba.LAUNCHES)
    whole = svc.sharded.gather() if sharded else svc.state
    if job.get("save"):
        mgr = CheckpointManager(job["save"],
                                async_save=job.get("async_save", False))
        svc.save_checkpoint(mgr)
        mgr.wait()
    if rank != 0:
        return None
    rows = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]} \
        if parts else {}
    if sel:
        rows["selected"] = np.concatenate(sel)
    return {"rows": rows, "summary": svc.summary(), "tick": svc.tick,
            "state": _host_state(whole), "ticks_per_second": n / wall,
            "collectives_per_tick": {k: v / max(n, 1)
                                     for k, v in collectives.items()},
            "launches_per_tick": {k: v / max(n, 1)
                                  for k, v in launches.items()}}


def service_jobs(rank: int, world: int, device, jobs: list) -> list:
    """Several :func:`service_job` runs in one process group, in order."""
    return [service_job(rank, world, device, job) for job in jobs]


def _gap(a: dict, b: dict, keys) -> float:
    """Scale-normalised max gap over ``keys`` (``replay_gap``'s)."""
    worst = 0.0
    for k in keys:
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        worst = max(worst, float(np.max(np.abs(x - y)) /
                                 max(1.0, np.max(np.abs(x)))))
    return worst


def demo(rank: int, world: int, device, args) -> Optional[dict]:
    """The launcher's program on one rank (see the module docstring)."""
    from ..checkpoint import CheckpointManager
    from ..service import summary_fingerprint
    from ..shard import barrier
    say = print if rank == 0 else (lambda *a, **k: None)
    job = {"scheduler": args.scheduler,
           "service": dict(SMOKE_SERVICE if args.smoke else FULL_SERVICE,
                           chunk_ticks=args.chunk),
           "sched": {"beta": args.beta},
           "trace": dict(scenario=args.scenario, pattern="poisson",
                         seed=args.seed,
                         **(SMOKE_SIZE if args.smoke else {}))}
    T, H = args.ticks, args.ticks // 2 // args.chunk * args.chunk
    keys = ("round_efficiency", "round_fairness", "round_fairness_norm",
            "round_jain", "n_allocated", "leftover")
    say(f"{args.scenario} / {args.scheduler}: {T} ticks, ring "
        f"{job['service']['block_slots']} blocks, {world} stripes, device "
        f"{device}")
    control = service_job(0, 1, device, dict(job, ticks=T), sharded=False)
    shard = service_job(rank, world, device, dict(job, ticks=T))
    if rank == 0:
        c, s = control["summary"], shard["summary"]
        say(f"  unsharded: eff {c['cumulative_efficiency']:.6f}, grants "
            f"{c['grants']}, {control['ticks_per_second']:.2f} ticks/s")
        say(f"  {world} stripes ({s['sharding']['blocks_per_shard']} blocks "
            f"each): eff {s['cumulative_efficiency']:.6f}, grants "
            f"{s['grants']}, {shard['ticks_per_second']:.2f} ticks/s, "
            f"collectives/tick {shard['collectives_per_tick']}; gap "
            f"{_gap(control['rows'], shard['rows'], keys):.2e}")
    # act 1: run half, checkpoint (rank 0 writes), crash
    import torch.distributed as dist
    ckpt = [args.ckpt or (tempfile.mkdtemp(prefix="elastic_service_")
                          if rank == 0 else None)]
    dist.broadcast_object_list(ckpt, src=0)     # one directory for all
    one, wide = (os.path.join(ckpt[0], d) for d in ("one", "wide"))
    if rank == 0:
        service_job(0, 1, device, dict(job, ticks=H, save=one),
                    sharded=False)
    barrier(None, torch.device(device))
    say(f"act 1: {H} ticks, checkpoint under {one}, crash")
    # act 2: a fresh service restores and finishes, bitwise
    back = service_job(0, 1, device, dict(job, ticks=T, restore=one),
                       sharded=False)
    same = back["state"].keys() == control["state"].keys() and all(
        np.array_equal(back["state"][k], control["state"][k])
        for k in back["state"])
    fp = (json.dumps(summary_fingerprint(back["summary"]), sort_keys=True)
          == json.dumps(summary_fingerprint(control["summary"]),
                        sort_keys=True))
    say(f"act 2: restored at {H}, finished at {T}: state bitwise {same}, "
        f"summary fingerprint equal {fp}")
    # act 3: 1 stripe -> `world` stripes -> 1 stripe
    mid = H + (T - H) // 2 // args.chunk * args.chunk
    hand = service_job(rank, world, device,
                       dict(job, ticks=mid, restore=one, save=wide))
    final = service_job(0, 1, device, dict(job, ticks=T, restore=wide),
                        sharded=False) if rank == 0 else None
    if rank != 0:
        return None
    # the chain's first leg is the control's first H ticks
    rows = {k: np.concatenate([control["rows"][k][:H], hand["rows"][k],
                               final["rows"][k]]) for k in keys}
    gap = _gap(control["rows"], rows, keys)
    say(f"act 3: 1 -> {world} stripes at tick {H}, {world} -> 1 at {mid}: "
        f"gap to the control {gap:.2e}")
    ok = same and fp and gap <= 1e-5 and \
        _gap(control["rows"], shard["rows"], keys) <= 1e-5
    say("OK" if ok else "FAILED")
    return {"ok": ok, "elastic_gap": gap, "bitwise": same and fp}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--shards", type=int, required=True)
    p.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    p.add_argument("--device", required=True)
    p.add_argument("--scheduler", default="dpf", choices=SCHEDULER_NAMES)
    p.add_argument("--scenario", default="paper_default")
    p.add_argument("--ticks", type=int, default=48)
    p.add_argument("--chunk", type=int, default=8)
    p.add_argument("--beta", type=float, default=2.2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt", default=None,
                   help="checkpoint directory (default: a new temp dir)")
    p.add_argument("--smoke", action="store_true",
                   help="the reference tests' small geometry (seconds)")
    args = p.parse_args(argv)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:   # torchrun
        import torch.distributed as dist
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if world != args.shards:
            raise SystemExit(f"--shards {args.shards} but torchrun started "
                             f"{world} ranks")
        dev = init_rank(rank, world, args.backend, args.device,
                        timeout=DEMO_TIMEOUT)
        try:
            out = demo(rank, world, dev, args)
        finally:
            dist.destroy_process_group()
        return 0 if rank != 0 or out["ok"] else 1
    out = spawn(demo, args.shards, backend=args.backend, device=args.device,
                args=(args,), timeout=DEMO_TIMEOUT)[0]
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

"""End-to-end FLaaS run: the paper's full pipeline on a real model.

Data analysts submit pipelines; each round DPBalance allocates privacy
budget over the live blocks; granted pipelines run DP-FedAvg rounds on the
~100M-parameter ``flaas-100m`` LM, with noise calibrated from the RDP
grant, block ledgers debited and stragglers dropped at the deadline.  The
same loop, defaults and numpy draw order (blocks, demands) as ``repro``'s
``examples/train_fl_e2e.py``, which also saves pipeline (0, 0)'s training
state every 4th round (``--ckpt``; ``CheckpointManager(keep_n=2)``).

    PYTHONPATH=src python -m repro_torch.launch.fl_e2e      # H100, full 100M
    PYTHONPATH=src python -m repro_torch.launch.fl_e2e --device cpu --small
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..checkpoint import CheckpointManager
from ..configs import get_arch, reduced
from ..core import RoundInputs, SchedulerConfig, schedule_round
from ..data.blocks import DeviceDataset
from ..privacy import BlockLedger, RdpAccountant
from ..training import (FedAvgConfig, TrainConfig, fl_round, make_loss_fn,
                        make_state)

FEDAVG = dict(cohort_size=5, over_select=1.25, deadline_frac=0.8,
              local_lr=0.02, clip=0.05)


def run(rounds: int = 12, devices: int = 8, analysts: int = 2,
        pipes: int = 3, small: bool = False, seq: int = 256,
        device="cuda", train: bool = True, log=None,
        ckpt: Optional[str] = None) -> Dict:
    """Run the FL loop; returns ``{"cfg", "records", "pipelines",
    "ledger", "checkpoints"}`` with one record per round.  ``train=False``
    runs the scheduler, ledger and accountants alone (the grants do not
    depend on training).  With ``ckpt`` (a directory), pipeline (0, 0)'s
    state is saved there after every 4th round, under the round's index.
    ``device`` defaults to CUDA and raises without it."""
    dev = resolve_device(device)
    mgr = None if ckpt is None else CheckpointManager(ckpt, keep_n=2)
    cfg = get_arch("flaas-100m")
    if small:
        cfg = reduced(cfg)

    ledger = BlockLedger()
    datasets = {d: DeviceDataset(d, tokens_per_block=4 * seq,
                                 vocab=cfg.vocab) for d in range(devices)}
    rng = np.random.default_rng(0)
    loss_fn = make_loss_fn(cfg)

    # each analyst's pipelines: (params, accountant, sigma, remaining rounds)
    M, N = analysts, pipes
    tcfg = TrainConfig(param_dtype="float32")
    pipelines = {}
    for i in range(M):
        for j in range(N):
            pipelines[(i, j)] = {
                "state": (make_state(17 * i + j, cfg, tcfg, device=dev)
                          if train else None),
                "acc": RdpAccountant(alpha_star=8.0),
                "granted": 0.0, "rounds_left": 0, "sigma": 0.0,
                "losses": [],
            }

    records: List[Dict] = []
    now = 0.0
    for rnd_idx in range(rounds):
        t_round = time.perf_counter()
        # 1. devices mint new blocks (privacy budget ~ U(1.0, 1.5))
        for d in range(devices):
            bid = ledger.create_block(d, float(rng.uniform(1.0, 1.5)), now)
            datasets[d].add_block(bid)
        live = ledger.live_blocks()
        K = len(ledger)

        # 2. pending pipelines' demands over live blocks
        demand = np.zeros((M, N, K), np.float32)
        active = np.zeros((M, N), bool)
        for (i, j), p in pipelines.items():
            if p["rounds_left"] > 0:
                continue                       # still training its last grant
            active[i, j] = True
            eps = float(rng.uniform(0.095, 0.105))
            for bid in live[-devices:]:        # latest block per device
                demand[i, j, bid] = eps
        rinp = RoundInputs.from_numpy(
            demand=demand, active=active,
            arrival=np.full((M, N), now, np.float32),
            loss=np.ones((M, N), np.float32),
            capacity=ledger.capacity_vector(range(K)),
            budget_total=ledger.budget_vector(range(K)), now=now,
            device=dev)

        # 3. DPBalance allocates; ledger debited with actual grants
        res = schedule_round(rinp, SchedulerConfig(beta=2.2))
        ledger.debit_grants(np.arange(K), res.consumed.cpu().numpy())
        sel = res.selected.cpu().numpy()
        grants_max = res.grants.amax(dim=-1).cpu().numpy()
        granted = []
        for (i, j), p in pipelines.items():
            if active[i, j] and sel[i, j]:
                grant = float(grants_max[i, j])
                p["granted"] = grant
                p["rounds_left"] = 1
                p["sigma"] = p["acc"].sigma_for_grant(grant, 1)
                granted.append({"pipeline": [i, j], "grant": grant,
                                "sigma": p["sigma"]})

        # 4. granted pipelines run one DP-FedAvg round each
        t_train = time.perf_counter()
        for (i, j), p in pipelines.items():
            if p["rounds_left"] <= 0:
                continue
            if train:
                data = {d: _client_loader(datasets[d], seq, rnd_idx, dev)
                        for d in range(devices)}
                new_params, _ = fl_round(
                    p["state"]["params"], loss_fn, data,
                    list(range(devices)),
                    FedAvgConfig(**FEDAVG, seed=rnd_idx),
                    accountant=p["acc"], sigma=p["sigma"],
                    round_idx=rnd_idx)
                p["state"]["params"] = new_params
                with torch.no_grad():
                    p["losses"].append(float(loss_fn(new_params,
                                                     data[0]()[0])))
            elif p["sigma"] > 0:
                p["acc"].record_step(p["sigma"])
            p["rounds_left"] -= 1

        last = [p["losses"][-1] for p in pipelines.values() if p["losses"]]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_end = time.perf_counter()
        rec = {"round": rnd_idx, "allocated": int(res.n_allocated),
               "efficiency": float(res.efficiency), "live_blocks": len(live),
               "selected": [[i, j] for (i, j) in pipelines
                            if active[i, j] and sel[i, j]],
               "granted": granted,
               "mean_pipeline_loss": float(np.mean(last)) if last
               else float("nan"),
               "wall_s": t_end - t_round, "train_s": t_end - t_train}
        records.append(rec)
        if log is not None:
            log(rec)
        if mgr is not None and train and rnd_idx % 4 == 3:
            mgr.save(rnd_idx, pipelines[(0, 0)]["state"])
        now += 10.0
    return {"cfg": cfg, "records": records, "pipelines": pipelines,
            "ledger": ledger,
            "checkpoints": [] if mgr is None else mgr.all_steps()}


def _client_loader(dataset: DeviceDataset, seq: int, rnd_idx: int, dev):
    def load():
        blocks = dataset.block_ids[-3:]
        t = dataset.sample(blocks, seq + 1, 2, seed=rnd_idx)
        t = torch.as_tensor(t, device=dev)
        return [{"tokens": t[:, :-1], "labels": t[:, 1:]}]
    return load


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--analysts", type=int, default=2)
    ap.add_argument("--pipes", type=int, default=3)
    ap.add_argument("--small", action="store_true",
                    help="reduced model (CI-speed)")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "flaas_ckpt"))
    args = ap.parse_args()

    def log(r):
        print(f"round {r['round']:3d}  allocated={r['allocated']}  "
              f"eff={r['efficiency']:.3f}  live_blocks={r['live_blocks']}  "
              f"mean_pipeline_loss={r['mean_pipeline_loss']:.3f}  "
              f"({r['wall_s']:.1f}s)", flush=True)

    out = run(args.rounds, args.devices, args.analysts, args.pipes,
              args.small, args.seq, args.device, log=log, ckpt=args.ckpt)
    cfg = out["cfg"]
    print(f"model={cfg.name} layers={cfg.n_layers} d={cfg.d_model}")
    p00 = out["pipelines"][(0, 0)]
    eps, alpha = p00["acc"].certify(delta=1e-5)
    print(f"pipeline(0,0): losses {p00['losses'][:2]} -> "
          f"{p00['losses'][-2:]}; certified ({eps:.3f}, 1e-5)-DP @ a={alpha}")
    print(f"checkpoints: {out['checkpoints']}")
    print(json.dumps(out["records"][-1]))


if __name__ == "__main__":
    main()

"""Fleet sweep: all four schedulers across a scenario fleet, on one device.

    PYTHONPATH=src python -m repro_torch.launch.sweep              # H100
    PYTHONPATH=src python -m repro_torch.launch.sweep --all-scenarios
    PYTHONPATH=src python -m repro_torch.launch.sweep --device cpu --smoke

The counterpart of ``examples/scenario_sweep.py``: for each scenario it
pre-generates ``--seeds`` episodes, stacks them on a fleet axis and runs
every scheduler over the fleet (:func:`repro_torch.core.run_fleet` with
``mode="auto"``: the episodes in lockstep on the card, one round of every
episode at a time, and one after another on the CPU, as ``repro`` picks
by backend), then prints the same table: final
cumulative efficiency and normalized fairness (mean and spread over
seeds), mean Jain index, pipelines allocated per episode and the fleet's
wall time.  The default is the paper's §VI geometry (100 devices, 6 x 25
pipelines, 10 rounds) on the card (``--device``, default ``cuda``; raises
without it); ``--smoke`` runs a reduced geometry (4 devices, 3 x 6
pipelines, 4 rounds) with 2 seeds.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import resolve_device
from ..core import (SCENARIOS, SCHEDULER_NAMES, SchedulerConfig, make_fleet,
                    resolve_fleet_mode, run_fleet)

SMOKE = dict(n_devices=4, n_analysts=3, pipelines_per_analyst=6,
             n_rounds=4)
SMOKE_SEEDS = 2


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sweep(scenario: str, n_seeds: int, sched_cfg: SchedulerConfig,
          size_overrides: dict, device="cuda", log=print) -> dict:
    """Run every scheduler over ``n_seeds`` episodes of ``scenario``;
    returns ``{scheduler: {"out": run_fleet's rows, "wall_s": s}}`` and
    prints one table row per scheduler through ``log``."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    fleet = make_fleet(scenario, n_seeds, device=dev, **size_overrides)
    gen_s = time.perf_counter() - t0
    M, N, K = fleet.demand.shape[1:]
    log(f"\n=== {scenario}: {n_seeds} seeds, M={M} N={N} K={K} "
        f"R={fleet.n_rounds} on {dev}, fleet mode "
        f"{resolve_fleet_mode('auto', dev)} (generated in {gen_s:.1f}s) ===")
    log(f"{'scheduler':<10} {'efficiency':>18} {'fairness_norm':>18} "
        f"{'jain':>12} {'alloc':>8} {'wall':>8}")
    res = {}
    for name in SCHEDULER_NAMES:
        _sync(dev)
        t0 = time.perf_counter()
        out = run_fleet(fleet, sched_cfg, name)
        _sync(dev)
        wall = time.perf_counter() - t0
        eff = out["cumulative_efficiency"][:, -1].double()
        fn = out["cumulative_fairness_norm"][:, -1].double()
        jain = out["round_jain"].double().mean(dim=1)
        alloc = out["n_allocated"].double().sum(dim=1)
        log(f"{name:<10} {eff.mean():9.3f} ±{eff.std(unbiased=False):6.3f} "
            f"{fn.mean():10.3f} ±{fn.std(unbiased=False):6.3f} "
            f"{jain.mean():6.3f}±{jain.std(unbiased=False):4.2f} "
            f"{alloc.mean():8.1f} {wall:7.2f}s")
        res[name] = {"out": out, "wall_s": wall}
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenario", default="paper_default",
                    choices=sorted(SCENARIOS))
    ap.add_argument("--all-scenarios", action="store_true",
                    help="sweep every named scenario")
    ap.add_argument("--seeds", type=int, default=None,
                    help=f"episodes per scenario (default 64, --smoke "
                         f"{SMOKE_SEEDS})")
    ap.add_argument("--beta", type=float, default=2.2)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced geometry (4 devices, 3 x 6 pipelines, "
                         "4 rounds)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seeds = args.seeds or (SMOKE_SEEDS if args.smoke else 64)
    size = SMOKE if args.smoke else {}
    cfg = SchedulerConfig(beta=args.beta)
    names = sorted(SCENARIOS) if args.all_scenarios else [args.scenario]
    return {name: sweep(name, seeds, cfg, size, args.device)
            for name in names}


if __name__ == "__main__":
    main()

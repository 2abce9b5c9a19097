"""Load generator CLI for the streaming service plane.

    python -m repro_torch.service.load --scenario paper_default \
        --pattern diurnal --ticks 200 --chunk 16 --scheduler dpbalance
    python -m repro_torch.service.load --device cpu --smoke   # seconds

Drives :class:`~repro_torch.service.server.FlaasService` with an unbounded
arrival trace and prints the streaming telemetry summary: throughput
(ticks/s, admissions/s), admission/rejection rates, queue depth, and grant
latency percentiles.  ``--verify`` additionally freezes the trace prefix
and checks replay parity against ``engine.run_episode``.  Runs on the
CUDA card unless ``--device cpu`` is given (then on the kernels' twins).
"""
from __future__ import annotations

import argparse
import sys

from ..core.registry import SCHEDULER_NAMES
from ..core.scenarios import SCENARIOS
from ..core.scheduler import SchedulerConfig

from .replay import replay_gap
from .server import FlaasService, ServiceConfig
from .traces import PATTERNS, make_trace

SMOKE_SIZE = dict(n_devices=4, n_analysts=4, pipelines_per_analyst=6,
                  n_rounds=4)


def _fmt(summary: dict) -> str:
    lat = summary["grant_latency_ticks"]
    lines = [
        f"  ticks={summary['ticks']}  "
        f"ticks/s={summary.get('ticks_per_second', float('nan')):.1f}  "
        f"admissions/s={summary.get('admissions_per_second', 0.0):.1f}",
        f"  cumulative_efficiency={summary['cumulative_efficiency']:.4f}  "
        f"cumulative_fairness_norm="
        f"{summary['cumulative_fairness_norm']:.4f}  "
        f"mean_jain={summary['mean_jain']:.3f}",
        f"  allocated={summary['total_allocated']}  "
        f"grants={summary['grants']}  "
        f"admission_rate={summary.get('admission_rate', 0.0):.2f}  "
        f"rejection_rate={summary.get('rejection_rate', 0.0):.2f}",
        f"  queue_depth mean={summary['queue_depth_mean']:.1f} "
        f"max={summary['queue_depth_max']}  "
        f"grant_latency p50={lat['p50']:.1f} p90={lat['p90']:.1f} "
        f"p99={lat['p99']:.1f} ticks",
    ]
    return "\n".join(lines)


def run_load(args) -> int:
    size = dict(SMOKE_SIZE) if args.smoke else {}
    trace = make_trace(args.scenario, args.pattern, seed=args.seed, **size)
    cfg = ServiceConfig(
        scheduler=args.scheduler, sched=SchedulerConfig(beta=args.beta),
        analyst_slots=args.analyst_slots, pipeline_slots=args.pipeline_slots,
        block_slots=max(args.block_slots, 10 * trace.blocks_per_tick),
        chunk_ticks=args.chunk, admit_batch=args.admit_batch,
        max_pending=args.max_pending)
    service = FlaasService(cfg, trace, device=args.device)
    summary = service.run(args.ticks)
    print(f"service[{args.scenario}/{args.pattern}/{args.scheduler}] "
          f"M={cfg.analyst_slots} N={cfg.pipeline_slots} "
          f"B={cfg.block_slots} chunk={cfg.chunk_ticks} "
          f"device={service.device}")
    print(_fmt(summary))

    if args.verify:
        gaps = replay_gap(trace.reset(), min(args.ticks, 10),
                          SchedulerConfig(beta=args.beta), args.scheduler,
                          chunk_ticks=args.chunk, device=args.device)
        worst = max(gaps.values())
        print(f"  replay parity vs engine.run_episode: max gap "
              f"{worst:.2e} ({'OK' if worst <= 1e-5 else 'FAIL'})")
        if worst > 1e-5:
            return 1
    return 0


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scenario", default="paper_default",
                   choices=sorted(SCENARIOS))
    p.add_argument("--pattern", default="poisson", choices=PATTERNS)
    p.add_argument("--scheduler", default="dpbalance",
                   choices=SCHEDULER_NAMES)
    p.add_argument("--ticks", type=int, default=64)
    p.add_argument("--chunk", type=int, default=8)
    p.add_argument("--beta", type=float, default=2.2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--analyst-slots", type=int, default=8)
    p.add_argument("--pipeline-slots", type=int, default=25)
    p.add_argument("--block-slots", type=int, default=4096)
    p.add_argument("--admit-batch", type=int, default=32)
    p.add_argument("--max-pending", type=int, default=1024)
    p.add_argument("--verify", action="store_true",
                   help="check replay parity against engine.run_episode")
    p.add_argument("--smoke", action="store_true",
                   help="tiny geometry + short run for CI (seconds)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    args = p.parse_args(argv)
    if args.smoke:
        args.ticks = min(args.ticks, 12)
        args.chunk = min(args.chunk, 4)
        args.analyst_slots = 4
        args.pipeline_slots = 6
        args.block_slots = 128
        args.verify = True
    sys.exit(run_load(args))


if __name__ == "__main__":
    main()

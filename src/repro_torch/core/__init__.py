"""DPBalance core on PyTorch -- the paper's scheduler (one round, the
baselines, the episode and fleet engine, scenarios and the legacy
simulator) with its hot-path sweeps on Hopper kernels."""
from .blockaxis import LOCAL, BlockAxis, grant_fits_scan
from .demand import (AnalystView, DemandView, RoundInputs, analyst_demand,
                     analyst_max_share, normalized_demand,
                     pipeline_max_share)
from .utility import (alpha_fair_objective, analyst_utility, default_lambda,
                      dominant_efficiency, dominant_fairness, jain_index,
                      platform_utility)
from .waterfill import WaterfillResult, alpha_fair_waterfill
from .packing import (PackResult, exact_pack, greedy_cover, pack_all,
                      pack_all_pruned, pack_analyst, swap_refine,
                      swap_refine_reference)
from .swap import (swap_batch_objectives, swap_candidate_cap,
                   swap_candidate_objectives, swap_candidates,
                   swap_prune_bounds, swap_refine_beam,
                   swap_refine_incremental)
from .scheduler import RoundResult, SchedulerConfig, schedule_round
from .baselines import dpf_round, dpk_round, fcfs_round
from .registry import (SCHEDULER_NAMES, SCHEDULERS, get_round_fn,
                       get_scheduler)
from .engine import (Episode, generate_episode, resolve_fleet_mode,
                     run_episode, run_fleet, stack_episodes)
from .scenarios import (SCENARIOS, get_scenario, make_fleet,
                        make_scenario_grid, scenario_config)
from .simulation import FlaasSimulator, SimConfig, run_simulation

__all__ = [
    "LOCAL", "BlockAxis", "grant_fits_scan",
    "AnalystView", "DemandView", "RoundInputs", "analyst_demand",
    "analyst_max_share",
    "normalized_demand", "pipeline_max_share", "alpha_fair_objective",
    "analyst_utility", "default_lambda", "dominant_efficiency",
    "dominant_fairness", "jain_index", "platform_utility", "WaterfillResult",
    "alpha_fair_waterfill", "PackResult", "exact_pack", "greedy_cover",
    "pack_all", "pack_all_pruned", "pack_analyst", "swap_refine",
    "swap_refine_reference",
    "swap_batch_objectives", "swap_candidate_cap",
    "swap_candidate_objectives", "swap_candidates", "swap_prune_bounds",
    "swap_refine_beam",
    "swap_refine_incremental", "RoundResult", "SchedulerConfig",
    "schedule_round", "dpf_round", "dpk_round", "fcfs_round",
    "SCHEDULER_NAMES", "SCHEDULERS", "get_round_fn", "get_scheduler",
    "Episode", "generate_episode", "resolve_fleet_mode", "run_episode",
    "run_fleet", "stack_episodes", "SCENARIOS", "get_scenario", "make_fleet",
    "make_scenario_grid", "scenario_config", "FlaasSimulator", "SimConfig",
    "run_simulation",
]

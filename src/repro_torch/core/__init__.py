"""DPBalance core on PyTorch -- the paper's scheduler (one round and the
episode loop) with its hot-path sweeps on Hopper kernels."""
from .blockaxis import LOCAL, BlockAxis, grant_fits_scan
from .demand import (AnalystView, DemandView, RoundInputs, analyst_demand,
                     analyst_max_share, normalized_demand,
                     pipeline_max_share)
from .utility import (alpha_fair_objective, analyst_utility, default_lambda,
                      dominant_efficiency, dominant_fairness, jain_index,
                      platform_utility)
from .waterfill import WaterfillResult, alpha_fair_waterfill
from .packing import (PackResult, greedy_cover, pack_all, swap_refine,
                      swap_refine_reference)
from .swap import (swap_batch_objectives, swap_candidate_cap,
                   swap_candidate_objectives, swap_candidates,
                   swap_refine_incremental)
from .scheduler import RoundResult, SchedulerConfig, schedule_round
from .simulation import SimConfig
from .engine import Episode, generate_episode, run_episode

__all__ = [
    "LOCAL", "BlockAxis", "grant_fits_scan",
    "AnalystView", "DemandView", "RoundInputs", "analyst_demand",
    "analyst_max_share", "normalized_demand", "pipeline_max_share",
    "alpha_fair_objective", "analyst_utility", "default_lambda",
    "dominant_efficiency", "dominant_fairness", "jain_index",
    "platform_utility", "WaterfillResult", "alpha_fair_waterfill",
    "PackResult", "greedy_cover", "pack_all", "swap_refine",
    "swap_refine_reference", "swap_batch_objectives", "swap_candidate_cap",
    "swap_candidate_objectives", "swap_candidates",
    "swap_refine_incremental", "RoundResult", "SchedulerConfig",
    "schedule_round", "SimConfig", "Episode", "generate_episode",
    "run_episode",
]

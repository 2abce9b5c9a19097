"""Paper §VI simulation environment: its configuration.

  * 100 edge devices; per-device global budget eps_g ~ U(1.0, 1.5); every
    device's blocks inherit the device budget.
  * 2 new blocks per device every 10 s (one round = 10 s).
  * 6 data analysts x 25 pipelines arriving via a Poisson process (one
    analyst batch per round on average), 10 rounds.
  * 75% mice pipelines (eps ~ U(0.005, 0.015)), 25% elephant
    (eps ~ U(0.095, 0.105)).
  * A pipeline demands the latest 10 blocks w.p. 0.25, else the latest 1.
  * An analyst targets 20% of devices w.p. 0.5, else all devices.

The legacy host-side simulator is not ported yet; episodes come from
:func:`repro_torch.core.engine.generate_episode`.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class SimConfig:
    n_devices: int = 100
    blocks_per_round_per_device: int = 2
    n_analysts: int = 6
    pipelines_per_analyst: int = 25
    n_rounds: int = 10
    mice_frac: float = 0.75
    mice_eps: tuple = (0.005, 0.015)
    elephant_eps: tuple = (0.095, 0.105)
    budget_range: tuple = (1.0, 1.5)
    p_ten_blocks: float = 0.25
    p_subset_devices: float = 0.5
    subset_frac: float = 0.2
    arrival_rate: float = 1.0  # Poisson analyst-batch arrivals per round
    seed: int = 0
    pad_blocks: bool = True  # pre-size K so shapes are static

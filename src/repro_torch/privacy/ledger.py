"""Per-block privacy ledgers (paper §IV-C privacy resource model).

Each data block carries a total RDP budget eps_g (inherited from its device:
eps_ij^g = eps_i^g), accumulates loss via sequential composition each time a
pipeline trains on it, and *retires* when exhausted.  The device-level loss is
the max over its blocks (parallel composition over disjoint time partitions).

The ledger is the source of truth the scheduler reads `capacity` from and the
training runtime debits after each granted round — the trainer cannot consume
privacy the scheduler did not grant (grants are checked here).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class BlockState:
    block_id: int
    device_id: int
    created_at: float
    budget: float          # eps_g total
    consumed: float = 0.0  # sum of sequential-composition debits
    retired: bool = False

    @property
    def remaining(self) -> float:
        return max(self.budget - self.consumed, 0.0)


class BlockLedger:
    """Tracks every block's lifecycle: create -> consume -> retire."""

    def __init__(self):
        self._blocks: List[BlockState] = []
        self._by_device: Dict[int, List[int]] = {}

    # ------------------------------------------------------------- lifecycle
    def create_block(self, device_id: int, budget: float, now: float) -> int:
        bid = len(self._blocks)
        self._blocks.append(BlockState(bid, device_id, now, float(budget)))
        self._by_device.setdefault(device_id, []).append(bid)
        return bid

    def consume(self, block_id: int, eps: float) -> None:
        """Sequential composition (Def 4): additive debit, never overdraw."""
        b = self._blocks[block_id]
        if b.retired:
            raise ValueError(f"block {block_id} is retired")
        if eps > b.remaining + 1e-6:
            raise ValueError(
                f"grant {eps:.6f} exceeds remaining {b.remaining:.6f} "
                f"on block {block_id} — scheduler/ledger disagreement")
        b.consumed = min(b.consumed + eps, b.budget)
        if b.remaining <= 1e-9:
            b.retired = True

    def debit_grants(self, block_ids: np.ndarray, grants: np.ndarray) -> None:
        """Vector debit for a whole round: grants[k] epsilon on block_ids[k]."""
        for bid, g in zip(np.asarray(block_ids), np.asarray(grants)):
            if g > 1e-12:
                self.consume(int(bid), float(g))

    # ------------------------------------------------------------ inspection
    def capacity_vector(self, block_ids) -> np.ndarray:
        return np.array([self._blocks[int(b)].remaining for b in block_ids],
                        np.float32)

    def budget_vector(self, block_ids) -> np.ndarray:
        return np.array([self._blocks[int(b)].budget for b in block_ids],
                        np.float32)

    def device_loss(self, device_id: int) -> float:
        """Parallel composition (Def 3): device loss = max over its blocks."""
        ids = self._by_device.get(device_id, [])
        return max((self._blocks[b].consumed for b in ids), default=0.0)

    def live_blocks(self) -> List[int]:
        return [b.block_id for b in self._blocks if not b.retired]

    def __len__(self) -> int:
        return len(self._blocks)

    def block(self, block_id: int) -> BlockState:
        return self._blocks[block_id]

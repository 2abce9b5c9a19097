"""Time-partitioned data blocks (paper §IV-C).

Each FL device owns a growing dataset partitioned into blocks by time; a
block's *content* here is a deterministic synthetic token stream seeded by
(device_id, block_id) so experiments are reproducible without external data
and every training run touching block k reads identical bytes.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


def block_tokens(device_id: int, block_id: int, n_tokens: int,
                 vocab: int) -> np.ndarray:
    """Deterministic tokens for one block (Philox-seeded)."""
    rng = np.random.default_rng(np.uint64(device_id) * 1_000_003
                                + np.uint64(block_id) + 17)
    return rng.integers(0, vocab, size=n_tokens, dtype=np.int32)


@dataclasses.dataclass
class DeviceDataset:
    """A device's local blocks; serves token slices for granted pipelines."""
    device_id: int
    tokens_per_block: int = 4096
    vocab: int = 32_000
    block_ids: List[int] = dataclasses.field(default_factory=list)

    def add_block(self, block_id: int) -> None:
        self.block_ids.append(block_id)

    def sample(self, block_ids, seq_len: int, batch: int,
               seed: int = 0) -> np.ndarray:
        """Batch of sequences drawn from the given granted blocks."""
        rng = np.random.default_rng(seed + self.device_id)
        pool = np.concatenate([
            block_tokens(self.device_id, b, self.tokens_per_block, self.vocab)
            for b in block_ids])
        starts = rng.integers(0, max(len(pool) - seq_len, 1), size=batch)
        return np.stack([
            np.resize(pool[s:s + seq_len], seq_len) for s in starts])

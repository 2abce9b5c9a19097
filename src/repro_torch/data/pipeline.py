"""Token batch pipeline: deterministic synthetic streams on a device."""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from .. import resolve_device


def synth_tokens(step: int, batch: int, seq_len: int, vocab: int,
                 seed: int = 0) -> dict:
    """Deterministic LM batch for step `step` (labels = next-token shift)."""
    rng = np.random.default_rng(np.uint64(seed) * 7_919 + np.uint64(step))
    toks = rng.integers(0, vocab, size=(batch, seq_len + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def batch_iterator(batch: int, seq_len: int, vocab: int, seed: int = 0,
                   device="cuda") -> Iterator[dict]:
    """Endless :func:`synth_tokens` batches as int32 tensors on ``device``
    (``"cuda"`` by default; raises when CUDA is unavailable)."""
    dev = resolve_device(device)

    def batches():
        step = 0
        while True:
            b = synth_tokens(step, batch, seq_len, vocab, seed)
            yield {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
                   for k, v in b.items()}
            step += 1
    return batches()

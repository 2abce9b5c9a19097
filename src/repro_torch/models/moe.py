"""Mixture-of-Experts block on PyTorch: ``repro``'s gather-based dispatch
(``repro/models/moe.py``), step by step.

  1. the router in float32: logits ``x @ router`` [T, E];
  2. each token's top k logits, ties to the lower expert index
     (``jax.lax.top_k``'s order, here a stable descending sort), and the
     softmax over those k values: the gates;
  3. the T*k assignments (token t's rank r is assignment ``t*k + r``)
     sorted by expert, stable (``jnp.argsort``'s order), the experts'
     counts (``bincount``) and offsets;
  4. per expert a slice of ``capacity`` slots of the sorted assignments,
     padded past the end with the sentinel ``T*k``, ``valid`` where a slot
     holds one of the expert's assignments: an expert takes its first
     ``capacity`` assignments in (token, rank) order, and a token over an
     expert's capacity gets nothing from that expert (it passes through
     the residual);
  5. the gathered batch [E, C, D] (invalid slots zero) and the expert
     products as ``torch.bmm`` in the banks' dtype (float32 with TF32 off,
     or bfloat16, the router staying float32): SwiGLU where the experts
     have ``w_gate``, else tanh-GELU (``jax.nn.gelu``'s default);
  6. the combine: each token's kept outputs, each times its gate, summed
     back to [T, D].

``repro`` combines with ``segment_sum`` over the slots, expert by expert.
The port gathers each token's k outputs and adds them one after another
in expert order, with no atomics, so a launch on the card is bitwise the
one before it; the dispatch and combine gather through ``F.embedding``,
whose backward adds in index order (``layers.embed``), so the gradients
are as reproducible.

``n_groups`` > 1 splits the T tokens into that many dispatch groups, each
routed on its own with ``capacity`` slots per expert, one after another
(``repro`` vmaps them).  Under a mesh the training step gathers the
expert banks whole for the ``torch.bmm`` (stored expert- and
FSDP-sharded by ``repro``'s rules:
:mod:`repro_torch.distributed.tensor_parallel`), and a rank dispatches
its own rows of a unit in its share of ``moe_dispatch_groups``;
``repro``'s expert-parallel compute (``_expert_compute_sharding``, an
all-to-all of tokens) is not ported.
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import torch
import torch.nn.functional as F

Params = Mapping[str, torch.Tensor]


def moe_capacity(n_tokens: int, top_k: int, n_experts: int,
                 capacity_factor: float) -> int:
    """Slots per expert: ``capacity_factor`` times an even share of the
    ``n_tokens * top_k`` assignments, rounded up to a multiple of 8, at
    least 8."""
    c = int(math.ceil(capacity_factor * n_tokens * top_k / n_experts))
    return max(8, -(-c // 8) * 8)


class Routing(NamedTuple):
    """One dispatch group's routing (T tokens, E experts, C slots)."""
    logits: torch.Tensor    # [T, E] float32, the router's
    experts: torch.Tensor   # [T, k] each token's experts, by rank (int64)
    gates: torch.Tensor     # [T, k] softmax of the top k logits
    blk: torch.Tensor       # [E, C] each slot's assignment t*k + r, or T*k
    valid: torch.Tensor     # [E, C] the slot holds one of its assignments
    slot: torch.Tensor      # [T, k] assignment's slot e*C + c, -1: dropped


def route(x, router, top_k: int, capacity: int) -> Routing:
    """Steps 1-4 for x [T, D] and the router [D, E]."""
    T = x.shape[0]
    E = router.shape[1]
    dev = x.device
    logits = x.float() @ router                                  # [T, E]
    topv, experts = torch.sort(logits, dim=-1, descending=True, stable=True)
    topv, experts = topv[:, :top_k], experts[:, :top_k]
    gates = torch.softmax(topv, dim=-1).to(x.dtype)

    flat = experts.reshape(-1)                                   # [T*k]
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=E)                   # [E]
    offsets = torch.cumsum(counts, 0) - counts
    sentinel = T * top_k
    padded = torch.cat([order, torch.full((capacity,), sentinel,
                                          dtype=order.dtype, device=dev)])
    cols = torch.arange(capacity, device=dev)
    blk = padded[offsets[:, None] + cols[None, :]]               # [E, C]
    valid = (cols[None, :] < counts[:, None]) & (blk < sentinel)

    # each assignment's place in its expert's slice: kept below capacity
    rank = torch.empty_like(order)
    rank[order] = torch.arange(sentinel, device=dev)
    within = rank - offsets[flat]
    slot = torch.where(within < capacity, flat * capacity + within,
                       torch.full_like(within, -1))
    return Routing(logits, experts, gates, blk, valid,
                   slot.reshape(T, top_k))


def _experts(xb, p: Params):
    """Step 5: [E, C, D] -> [E, C, D] through each expert's MLP."""
    if "w_gate" in p:
        h = F.silu(torch.bmm(xb, p["w_gate"])) * torch.bmm(xb, p["w_up"])
    else:
        h = F.gelu(torch.bmm(xb, p["w_up"]), approximate="tanh")
    return torch.bmm(h, p["w_down"])


def _moe_local(x, p: Params, top_k: int, capacity: int):
    T, D = x.shape
    r = route(x, p["router"], top_k, capacity)
    tok = torch.where(r.valid, r.blk // top_k, torch.zeros_like(r.blk))
    xb = F.embedding(tok, x) * r.valid[..., None].to(x.dtype)    # [E, C, D]
    yb = _experts(xb, p).reshape(-1, D)                          # [E*C, D]

    # step 6: a token's kept outputs times their gates, in expert order
    by_expert = torch.argsort(r.experts, dim=-1, stable=True)
    slot = torch.gather(r.slot, 1, by_expert)
    gates = torch.gather(r.gates, 1, by_expert)
    parts = F.embedding(slot.clamp(min=0), yb) * gates[..., None]
    kept = (slot >= 0)[..., None]
    out = torch.where(kept[:, 0], parts[:, 0], torch.zeros_like(x))
    for i in range(1, top_k):
        out = out + torch.where(kept[:, i], parts[:, i], torch.zeros_like(x))
    return out.to(x.dtype)


def moe_apply(x, params: Params, *, top_k: int, capacity: int, act: str,
              n_groups: int = 1):
    """x [T, D] -> [T, D].  ``params`` holds ``router`` [D, E], ``w_up``
    [E, D, F], ``w_down`` [E, F, D] and, for SwiGLU experts, ``w_gate``
    [E, D, F].  ``capacity`` is per expert and per group; ``act`` is
    ``repro``'s argument, which the experts' leaves decide (``w_gate``
    present: SwiGLU)."""
    del act
    if n_groups > 1:
        T, D = x.shape
        if T % n_groups:
            raise ValueError(f"{T} tokens do not split into {n_groups} "
                             "dispatch groups")
        xg = x.reshape(n_groups, T // n_groups, D)
        return torch.cat([_moe_local(xs, params, top_k, capacity)
                          for xs in xg])
    return _moe_local(x, params, top_k, capacity)


def aux_load_balance_loss(logits, topi, n_experts: int):
    """Switch-style auxiliary load-balancing loss: ``n_experts`` times the
    sum over experts of (the fraction of tokens whose first choice it is)
    times (its mean router probability)."""
    probs = torch.softmax(logits.float(), dim=-1)
    frac = torch.mean(F.one_hot(topi[..., 0].long(), n_experts).float(),
                      dim=0)
    prob = torch.mean(probs, dim=0)
    return n_experts * torch.sum(frac * prob)

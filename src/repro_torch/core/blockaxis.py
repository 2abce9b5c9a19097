"""The block axis of the scheduler's ``[..., K]`` sweeps.

``repro`` threads a :class:`BlockAxis` through every stage so that one code
path serves a single device (``LOCAL``: identity hooks) and a block-sharded
mesh (collectives).  This slice of the port runs on one device: only
``LOCAL`` exists, and asking for a sharded axis raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class BlockAxis:
    """The block axis; ``name`` is the mesh axis the blocks are sharded
    over (None = one device)."""

    name: Optional[str] = None

    @property
    def sharded(self) -> bool:
        return self.name is not None


LOCAL = BlockAxis(None)


def require_local(block_axis: BlockAxis) -> None:
    if block_axis.sharded:
        raise NotImplementedError(
            "a sharded block axis is not ported yet; use LOCAL")


def grant_fits_scan(dems, act, remaining, feas: float):
    """Sequential grant-if-fits sweep over pre-ordered visits, batched over
    leading dims.

    ``dems [..., V, K]`` are the visits' demand rows, ``act [..., V]``
    their activity, ``remaining [..., K]`` the capacity.  Returns
    ``(remaining_after, taken [..., V] bool)`` with, in visit order,
    ``taken_v = act_v and all_k dem_vk <= remaining_k + feas`` and
    ``remaining -= dem_v`` where taken (``repro``'s local ``lax.scan``)."""
    taken = []
    for v in range(dems.shape[-2]):
        dem = dems[..., v, :]
        ok = act[..., v] & torch.all(dem <= remaining + feas, dim=-1)
        remaining = torch.where(ok[..., None], remaining - dem, remaining)
        taken.append(ok)
    return remaining, torch.stack(taken, dim=-1)

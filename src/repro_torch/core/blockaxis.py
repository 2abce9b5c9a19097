"""Cross-shard reduction hooks for the scheduler's block-axis sweeps.

Every scheduler stage sweeps the block axis somewhere: the dominant-share
row-max (Eq 3/4), the waterfill dual-ascent matvecs, SP2's feasibility
checks, the kappa-boost water level.  On one device those are plain
reductions; on a block-sharded service (:mod:`repro_torch.shard`) each
process holds only its stripe of the ``[..., B]`` arrays and the *same*
code must finish each reduction with a collective over the stripes.

:class:`BlockAxis` is that seam.  :data:`LOCAL` (``name=None``) makes every
hook the identity, so the single-device path runs exactly the ops it runs
without the seam.  A sharded axis carries a ``torch.distributed`` process
group (one rank per stripe) and each hook becomes an ``all_reduce`` on a
copy of its argument.

Convention (``repro``'s): callers reduce their *local* stripe first, then
hand the partial result to the hook -- ``bx.max(torch.amax(g, -1))`` -- so
a collective's payload is analyst- or pipeline-indexed, never
block-indexed.  Every data-dependent loop decides on post-collective
values only, so all ranks issue the same collectives in the same order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

# collectives issued since the last reset: the sharded hooks' all_reduce
# calls, and the sharded service's all_gather calls (repro_torch.shard)
COLLECTIVES = {"all_reduce": 0, "all_gather": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


@dataclasses.dataclass(frozen=True)
class BlockAxis:
    """Reduction hooks over the (possibly sharded) block axis.

    ``name`` names the sharded axis (None: one device).  ``group`` is the
    ``torch.distributed`` process group whose ranks hold the stripes
    (None: the default group).  ``fits_segment`` sizes the visit segments
    of :func:`grant_fits_scan` on a sharded axis: one collective per
    segment refinement instead of one per visited pipeline."""

    name: Optional[str] = None
    fits_segment: int = 8
    group: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def sharded(self) -> bool:
        return self.name is not None

    @property
    def size(self) -> int:
        """Stripes on the axis (ranks of the group; 1 when local)."""
        if not self.sharded:
            return 1
        import torch.distributed as dist
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        """This process's stripe (0 when local)."""
        if not self.sharded:
            return 0
        import torch.distributed as dist
        return dist.get_rank(self.group)

    def _reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """``x`` all-reduced with ``ReduceOp.<op>`` on a copy (identity
        on the local axis)."""
        if not self.sharded:
            return x
        import torch.distributed as dist
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=getattr(dist.ReduceOp, op), group=self.group)
        COLLECTIVES["all_reduce"] += 1
        return y

    # partial-result combiners: x is the local stripe's reduction
    def max(self, x):
        return self._reduce(x, "MAX")

    def min(self, x):
        return self._reduce(x, "MIN")

    def sum(self, x):
        return self._reduce(x, "SUM")

    # boolean combiners, through int32 (no backend reduces bool)
    def any(self, x):
        if not self.sharded:
            return x
        return self.max(x.to(torch.int32)).to(torch.bool)

    def all(self, x):
        if not self.sharded:
            return x
        return self.min(x.to(torch.int32)).to(torch.bool)


LOCAL = BlockAxis(None)


def grant_fits_scan(dems, act, remaining, feas: float,
                    block_axis: BlockAxis = LOCAL):
    """Sequential grant-if-fits sweep over pre-ordered visits, batched over
    leading dims.

    ``dems [..., V, K]`` are the visits' (local-stripe) demand rows, ``act
    [..., V]`` their activity, ``remaining [..., K]`` the local capacity.
    Returns ``(remaining_after, taken [..., V] bool)`` with, in visit
    order, ``taken_v = act_v and all_k dem_vk <= remaining_k + feas``
    (over every stripe's k) and ``remaining -= dem_v`` where taken
    (``repro``'s local ``lax.scan``).

    On a sharded axis the per-step check would cost one collective per
    visit.  Visits go instead in segments of ``block_axis.fits_segment``:
    a refinement evaluates the whole segment's fits under a guessed
    in-segment decision vector with ONE ``[..., G]``-payload MIN, then
    adopts the result as the next guess.  A guess correct on its first
    ``p`` entries yields verdicts correct on ``p + 1`` (each verdict
    depends on earlier decisions only), so the loop stops at the unique
    self-consistent vector within G refinements; it stops when the guess
    reproduces itself, a post-collective test every rank takes alike.  The
    remaining capacity is the one computed under the converged decisions,
    with the per-step subtraction order, so decisions and arithmetic are
    bitwise the per-step scan's on any shard count."""
    if not block_axis.sharded or block_axis.fits_segment <= 1:
        taken = []
        for v in range(dems.shape[-2]):
            dem = dems[..., v, :]
            ok = act[..., v] & block_axis.all(
                torch.all(dem <= remaining + feas, dim=-1))
            remaining = torch.where(ok[..., None], remaining - dem, remaining)
            taken.append(ok)
        return remaining, torch.stack(taken, dim=-1)

    G = int(block_axis.fits_segment)
    taken = []
    for s0 in range(0, dems.shape[-2], G):
        dem_g, act_g = dems[..., s0:s0 + G, :], act[..., s0:s0 + G]

        def refine(dec, rem=remaining, dem_g=dem_g, act_g=act_g):
            """The segment's fits and end state under decisions ``dec``:
            a local scan, then one collective."""
            fits = []
            for v in range(dem_g.shape[-2]):
                d = dem_g[..., v, :]
                fits.append(act_g[..., v] &
                            torch.all(d <= rem + feas, dim=-1))
                rem = torch.where(dec[..., v, None], rem - d, rem)
            return rem, block_axis.all(torch.stack(fits, dim=-1))

        dec = torch.zeros_like(act_g)
        r_end, fits = refine(dec)
        while bool(torch.any(dec != fits)):
            dec = fits
            r_end, fits = refine(dec)
        remaining = r_end
        taken.append(fits)
    return remaining, torch.cat(taken, dim=-1)

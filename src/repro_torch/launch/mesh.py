"""Meshes over the ranks of a ``torch.distributed`` world: the production
mesh builders of ``repro/launch/mesh.py`` and :func:`make_mesh` for any
shape.

Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2, data=16,
model=16) = 512 ranks; DP composes over ('pod', 'data'), and 'pod' is
also the pipeline axis (:mod:`repro_torch.distributed.pipeline_parallel`).

A :class:`Mesh` lays its ranks out row-major over its axes (the last axis
fastest), so rank ``r`` of a (data, model) = (2, 2) mesh sits at (r // 2,
r % 2).  A world larger than the mesh holds several copies of it, ranks
``[c * n, (c + 1) * n)`` the c-th, each running on its own (how
:func:`make_host_mesh` gives every rank a (1, 1) mesh of its own).

The collectives are plain local tensors and explicit calls, one process
group per slice of the mesh along any set of its axes (made once, by
every rank, when the mesh is built).  Under NCCL a tensor travels on its
card; under any other backend (Gloo: ranks sharing one card, or the
CPU) through the host, since Gloo reduces CUDA tensors but gathers and
sends none.  A slice of one rank needs no group and no communication.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch


class Mesh:
    """``axis_names``, ``shape`` (``{axis: size}``, as ``repro``'s meshes
    give it), this rank's ``coords`` (``{axis: index}``), and the
    collectives along any of its axes."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        import torch.distributed as dist
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} for axes "
                             f"{tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))
        self.size = math.prod(shape)
        on = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if on else 1
        self.rank = dist.get_rank() if on else 0
        if world % self.size:
            raise ValueError(f"a world of {world} ranks does not hold "
                             f"copies of a {self.size}-rank mesh "
                             f"{self.shape}")
        n_copies = world // self.size
        base = (self.rank // self.size) * self.size
        local = self.rank - base
        self.coords: Dict[str, int] = {}
        for a in reversed(self.axis_names):
            local, self.coords[a] = divmod(local, self.shape[a])
        self.nccl = on and dist.get_backend() == "nccl"
        # one group per slice along every set of axes (all ranks call
        # new_group for every slice of every copy, in the same order)
        self._groups: Dict[Tuple[str, ...], object] = {}
        if not on:
            return
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                if math.prod(self.shape[a] for a in axes) == 1:
                    continue
                for copy in range(n_copies):
                    for ranks in self._slices(axes, copy * self.size):
                        g = dist.new_group(ranks)
                        if self.rank in ranks:
                            self._groups[axes] = g

    def _slices(self, axes, base):
        """Every slice of the mesh along ``axes`` (global ranks)."""
        others = [a for a in self.axis_names if a not in axes]
        strides, s = {}, 1
        for a in reversed(self.axis_names):
            strides[a] = s
            s *= self.shape[a]
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            off = base + sum(i * strides[a] for a, i in zip(others, fixed))
            yield sorted(
                off + sum(i * strides[a] for a, i in zip(axes, idx))
                for idx in itertools.product(*(range(self.shape[a])
                                               for a in axes)))

    def __repr__(self):
        return f"Mesh({self.shape}, coords={self.coords})"

    # ---------------------------------------------------------- collectives
    def _axes(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def n(self, axes) -> int:
        """The number of ranks in this rank's slice along ``axes``."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def index(self, axes) -> int:
        """This rank's place in its slice along ``axes`` (first axis
        major)."""
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes):
        return self._groups[self._axes(axes)]

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.nccl else t.cpu()

    def all_reduce(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The sum of ``t`` over this rank's slice along ``axes`` (a new
        tensor on ``t``'s device; ``t`` itself where the slice is one
        rank)."""
        if self.n(axes) == 1:
            return t
        import torch.distributed as dist
        x = self._wire(t).clone().contiguous()
        dist.all_reduce(x, group=self.group(axes))
        return x.to(t.device)

    def all_gather(self, t: torch.Tensor, axes, dim: int = 0
                   ) -> torch.Tensor:
        """Every rank's ``t`` in this rank's slice along ``axes``,
        concatenated along ``dim`` in slice order."""
        n = self.n(axes)
        if n == 1:
            return t
        import torch.distributed as dist
        x = self._wire(t).contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=self.group(axes))
        return torch.cat(parts, dim=dim).to(t.device)

    def all_gather_many(self, ts, axes, dims):
        """Each tensor of ``ts`` (one dtype) gathered over ``axes`` along
        its dim in ``dims``, as :meth:`all_gather` gives it, in one
        collective (the tensors travel flattened, one after another)."""
        n = self.n(axes)
        if n == 1 or not ts:
            return list(ts)
        if len(ts) == 1:
            return [self.all_gather(ts[0], axes, dims[0])]
        import torch.distributed as dist
        flat = self._wire(torch.cat([t.reshape(-1) for t in ts]))
        parts = [torch.empty_like(flat) for _ in range(n)]
        dist.all_gather(parts, flat, group=self.group(axes))
        out, off = [], 0
        for t, d in zip(ts, dims):
            k = t.numel()
            out.append(torch.cat([q[off:off + k].view(t.shape)
                                  for q in parts], dim=d).to(t.device))
            off += k
        return out

    def from_first(self, t: Optional[torch.Tensor], axes,
                   like: torch.Tensor) -> torch.Tensor:
        """The value of the slice's first rank (index 0 along ``axes``) on
        every rank of the slice: a sum in which every other rank adds
        zeros, so the value arrives bitwise.  ``t`` is read on the first
        rank only; ``like`` gives the shape, dtype and device."""
        if self.n(axes) == 1:
            return t
        mine = t if self.index(axes) == 0 else torch.zeros_like(like)
        return self.all_reduce(mine, axes)

    def sendrecv(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Send ``t`` to the next rank along ``axis`` (cyclic) and return
        what the previous one sent: ``jax.lax.ppermute`` with ``i -> i +
        1``."""
        n = self.shape[axis]
        if n == 1:
            return t
        import torch.distributed as dist
        g = self.group(axis)
        i = self.coords[axis]
        to = dist.get_global_rank(g, (i + 1) % n)
        frm = dist.get_global_rank(g, (i - 1) % n)
        x = self._wire(t).contiguous()
        got = torch.empty_like(x)
        reqs = [dist.isend(x, to, group=g), dist.irecv(got, frm, group=g)]
        for r in reqs:
            r.wait()
        return got.to(t.device)


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A mesh of ``shape`` over the world's ranks (every rank must call
    it): one copy when the world has ``prod(shape)`` ranks, several when
    it has a multiple of that."""
    return Mesh(shape, axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(data 16, model 16), or with ``multi_pod`` (pod 2, data 16, model
    16): the world must have exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = _world()
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} "
                         f"needs {math.prod(shape)} ranks; the world has "
                         f"{world}")
    return make_mesh(shape, axes)


def make_host_mesh() -> Mesh:
    """The degenerate (1, 1) mesh: every rank a mesh of its own."""
    return make_mesh((1, 1), ("data", "model"))


def _world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def launch_mesh(multi_pod: bool = False) -> Mesh:
    """``repro``'s launchers' mesh by the world's size (``launch/train.py``
    and ``launch/serve.py`` alike): the production mesh at 256 ranks or
    more, else the host mesh."""
    return make_production_mesh(multi_pod=multi_pod) if _world() >= 256 \
        else make_host_mesh()


def launch_dtype() -> str:
    """``repro``'s launchers' parameter dtype: float32 on one rank,
    bfloat16 on more."""
    return "float32" if _world() == 1 else "bfloat16"

"""Architecture registry of the port: ``get_arch(name)``.

The schema (:mod:`.base`) is a copy of ``repro``'s.  The port knows
``flaas-100m``, the paper's FL payload model, and ``recurrentgemma-2b``
(``rec`` + ``local`` blocks); every other architecture of ``repro`` waits
for its blocks (ROADMAP.md, Queue 1).
"""
from .base import (ArchConfig, EncoderSpec, LM_SHAPES, MoESpec, ShapeSpec,
                   reduced, shapes_for)
from .flaas_100m import CONFIG as flaas_100m
from .recurrentgemma_2b import CONFIG as recurrentgemma_2b

ARCHS = {c.name: c for c in (flaas_100m, recurrentgemma_2b)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (the port knows "
            f"{sorted(ARCHS)}; see ROADMAP.md, Queue 1)")
    return ARCHS[name]


__all__ = ["ArchConfig", "EncoderSpec", "MoESpec", "ShapeSpec", "LM_SHAPES",
           "ARCHS", "get_arch", "reduced", "shapes_for"]

"""Architecture registry of the port: ``get_arch(name)``.

The schema (:mod:`.base`) is a copy of ``repro``'s.  This slice of the
port knows ``flaas-100m`` only, the paper's FL payload model; every other
architecture of ``repro`` waits for its blocks (ROADMAP.md, Queue 1).
"""
from .base import (ArchConfig, EncoderSpec, LM_SHAPES, MoESpec, ShapeSpec,
                   reduced, shapes_for)
from .flaas_100m import CONFIG as flaas_100m

ARCHS = {flaas_100m.name: flaas_100m}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (the port knows "
            f"{sorted(ARCHS)}; see ROADMAP.md, Queue 1)")
    return ARCHS[name]


__all__ = ["ArchConfig", "EncoderSpec", "MoESpec", "ShapeSpec", "LM_SHAPES",
           "ARCHS", "get_arch", "reduced", "shapes_for"]

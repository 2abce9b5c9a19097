"""Architecture registry of the port: ``get_arch(name)``.

The schema (:mod:`.base`) and every config module are copies of
``repro``'s, and the port knows every architecture ``repro`` knows:
``flaas-100m``, the paper's FL payload model; the dense GQA family
(``qwen2.5-3b``, ``qwen2.5-32b``, ``starcoder2-3b``, ``starcoder2-15b``:
``attn`` blocks with QKV biases); ``recurrentgemma-2b`` (``rec`` +
``local`` blocks); ``xlstm-125m`` (``mlstm`` + ``slstm`` blocks);
``llama-3.2-vision-11b`` (``attn`` + ``xattn`` blocks over a stub image
memory); ``whisper-medium`` (an ``attn`` encoder over stub frames,
``encdec`` decoder blocks); and the MoE family, ``mixtral-8x22b``
(``swa`` blocks, 8 experts top 2) and ``kimi-k2-1t-a32b`` (a dense
``attn`` prefix layer, then ``attn`` blocks with 384 experts top 8 and a
shared expert).
"""
from .base import (ArchConfig, EncoderSpec, LM_SHAPES, MoESpec, ShapeSpec,
                   reduced, shapes_for)
from .flaas_100m import CONFIG as flaas_100m
from .kimi_k2_1t_a32b import CONFIG as kimi_k2_1t_a32b
from .llama_3_2_vision_11b import CONFIG as llama_3_2_vision_11b
from .mixtral_8x22b import CONFIG as mixtral_8x22b
from .qwen2_5_32b import CONFIG as qwen2_5_32b
from .qwen2_5_3b import CONFIG as qwen2_5_3b
from .recurrentgemma_2b import CONFIG as recurrentgemma_2b
from .starcoder2_15b import CONFIG as starcoder2_15b
from .starcoder2_3b import CONFIG as starcoder2_3b
from .whisper_medium import CONFIG as whisper_medium
from .xlstm_125m import CONFIG as xlstm_125m

ARCHS = {c.name: c for c in (
    flaas_100m, recurrentgemma_2b, xlstm_125m, qwen2_5_32b, starcoder2_3b,
    starcoder2_15b, qwen2_5_3b, llama_3_2_vision_11b, whisper_medium,
    mixtral_8x22b, kimi_k2_1t_a32b)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ArchConfig", "EncoderSpec", "MoESpec", "ShapeSpec", "LM_SHAPES",
           "ARCHS", "get_arch", "reduced", "shapes_for"]

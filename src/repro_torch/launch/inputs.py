"""What the launchers feed a model with cross attention beside its tokens
(``launch/serve.py``, ``launch/train.py``)."""
from __future__ import annotations

import torch

from ..models.transformer import reads_memory


def cross_inputs(cfg, batch: int, dev: torch.device, memory=None,
                 enc_frames=None, dtype=torch.float32):
    """``{"memory": x}`` for a model with ``xattn`` blocks,
    ``{"enc_frames": x}`` for an encoder-decoder, ``{}`` for a model
    without cross attention: the given tensor on ``dev`` in ``dtype`` (the
    model's parameter dtype, as ``repro``'s launcher makes it), or zeros
    [batch, cross_memory_len, d_model], the stub ``repro``'s launcher
    gives (its vision tower and audio frontend are stubs).
    Raises where the model takes no such input or takes the other one."""
    if not reads_memory(cfg):
        if memory is not None or enc_frames is not None:
            raise ValueError(f"{cfg.name} has no cross attention")
        return {}
    name, given, other = (("enc_frames", enc_frames, memory)
                          if cfg.encoder is not None
                          else ("memory", memory, enc_frames))
    if other is not None:
        raise ValueError(f"{cfg.name} takes {name} only")
    if given is None:
        given = torch.zeros((batch, cfg.cross_memory_len, cfg.d_model),
                            dtype=dtype, device=dev)
    return {name: given.to(dev, dtype)}

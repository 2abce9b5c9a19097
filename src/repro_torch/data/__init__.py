"""Data substrate: time-partitioned device blocks + token pipelines."""
from .blocks import DeviceDataset, block_tokens
from .pipeline import batch_iterator, synth_tokens

__all__ = ["DeviceDataset", "block_tokens", "batch_iterator", "synth_tokens"]

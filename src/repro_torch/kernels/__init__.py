"""Hopper kernels of the scheduler hot path and their plain twins."""

"""Hydra-style YAML composition (JAX: motionpriorcmax_tpu/config/)."""

from .core import apply_overrides, compose

__all__ = ["apply_overrides", "compose"]

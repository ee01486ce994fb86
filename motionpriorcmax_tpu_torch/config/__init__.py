"""Hydra-style YAML composition (JAX: motionpriorcmax_tpu/config/)."""

from .core import apply_overrides, compose, load_yaml, propagate_config

__all__ = ["apply_overrides", "compose", "load_yaml", "propagate_config"]

"""Plain tensor ops of the port (JAX: motionpriorcmax_tpu/ops/)."""

from .scatter import scatter_add_1d, scatter_add_direct

__all__ = ["scatter_add_1d", "scatter_add_direct"]

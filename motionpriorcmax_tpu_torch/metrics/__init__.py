"""Flow and trajectory metrics (JAX: motionpriorcmax_tpu/metrics/)."""

from .core import MetricBank

__all__ = ["MetricBank"]

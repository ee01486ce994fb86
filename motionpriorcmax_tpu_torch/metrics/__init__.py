"""Flow and trajectory metrics (JAX: motionpriorcmax_tpu/metrics/)."""

from .core import MetricBank
from .error_calculator import OpticalFlowError, make_error_calculator

__all__ = ["MetricBank", "OpticalFlowError", "make_error_calculator"]

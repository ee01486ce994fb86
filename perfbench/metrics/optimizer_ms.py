"""Device ms per step in the program's step.optimizer spans (zero_grad,
the zero-fill of missing gradients, AdamW's step and the schedule's),
from their CUDA events in the traced stretch."""

from ._program import span_ms_per_step


def read(run: dict, suffix: str):
    return span_ms_per_step(run, suffix, ("step.optimizer",))

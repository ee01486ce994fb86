"""Device ms per step in the program's model.forward and model.backward
spans (the model's forward, and its part of the backward, split from the
loss's part where the gradient of the model's output is complete), from
their CUDA events in the traced stretch."""

from ._program import span_ms_per_step


def read(run: dict, suffix: str):
    return span_ms_per_step(run, suffix, ("model.forward", "model.backward"))

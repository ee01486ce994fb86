"""Device ms per step in the program's loss.forward and loss.backward
spans (the focus loss, with the sampling of the curves where the model
gives curves, and its part of the backward), from their CUDA events in
the traced stretch."""

from ._program import span_ms_per_step


def read(run: dict, suffix: str):
    return span_ms_per_step(run, suffix, ("loss.forward", "loss.backward"))

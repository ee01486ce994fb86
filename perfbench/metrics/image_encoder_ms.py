"""Device ms per step in the program's model.encode_images spans
(RAFT-Spline's frame encoder over both boundary frames), from their CUDA
events in the traced stretch."""

from ._program import span_ms_per_step


def read(run: dict, suffix: str):
    return span_ms_per_step(run, suffix, ("model.encode_images",))

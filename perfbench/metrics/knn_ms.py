"""Device ms per step in the program's loss.knn span (the KNN of the
loss's forward: distances, the distance gemm, top-k and the gather), from
its CUDA events in the traced stretch."""

from ._program import span_ms_per_step


def read(run: dict, suffix: str):
    return span_ms_per_step(run, suffix, ("loss.knn",))

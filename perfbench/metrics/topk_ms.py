"""Device ms per step in top-k kernels: the exact KNN's selection."""

from ._stretch import class_ms_per_step


def read(run: dict, suffix: str):
    return class_ms_per_step(run, suffix, "topk")

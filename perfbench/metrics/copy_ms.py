"""Device ms per step in copy, cast and memcpy kernels (classed by name,
perfbench/kernels/classes.json)."""

from ._stretch import class_ms_per_step


def read(run: dict, suffix: str):
    return class_ms_per_step(run, suffix, "copy")

"""The model FLOPs of the stretch's steps (counted on the reference model,
perfbench/roofline/flops.py) over (the stretch's seconds x the
configuration's dense peak), in percent."""

from ._stretch import stretch


def read(run: dict, suffix: str):
    s = stretch(run, suffix)
    if s is None:
        return None
    return 100.0 * run["flops_per_step"] * s[1] / (s[0] * run["peak_flops"])

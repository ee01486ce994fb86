"""Device ns per looked-up correlation window in the corr-window kernels,
forward and backward together: their device time per step in the traced
stretch (kernels matched by their symbols' common stem) over the windows
a step looks up (the program's corr.windows counter over its steps.train
counter, both counted over the whole process; every training step looks
up as many).  Nothing to read without the counter or the kernels."""

from .. import trace
from . import _program
from ._stretch import stretch

STEM = "corr_window_lookup"


def read(run: dict, suffix: str):
    s = stretch(run, suffix)
    if s is None:
        return None
    snap = _program.snapshot()
    if snap is None:
        return None
    counters = snap["counters"]
    windows = counters.get("corr.windows", 0)
    steps = counters.get(_program.STEP_COUNTER[run["kind"]], 0)
    if windows <= 0 or steps <= 0:
        return None
    us = sum(b - a for a, b, name in
             trace.device_intervals(run["events"], run["stretch_us"])
             if STEM in name)
    if us <= 0:
        return None
    return us * 1e3 / s[1] / (windows / steps)

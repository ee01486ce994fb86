"""What the per-layer readers share: the traced stretch's length, its
steps, and device seconds by kernel class."""

from .. import trace


def stretch(run: dict, suffix: str):
    """(stretch seconds, steps in it), or None for a run without a trace
    or of another kind of cell than `suffix` names."""
    if "events" not in run or run["stretch_us"] is None:
        return None
    if suffix and suffix != run["kind"]:
        return None
    lo, hi = run["stretch_us"]
    return (hi - lo) / 1e6, run["stretch_steps"]


def class_ms_per_step(run: dict, suffix: str, cls: str):
    s = stretch(run, suffix)
    if s is None:
        return None
    secs = trace.class_seconds(run["events"], run["stretch_us"],
                               run["classes"]).get(cls)
    return None if not secs else secs * 1e3 / s[1]

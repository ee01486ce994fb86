"""Sum of least times over sum of device times of the port's own kernel
calls in the traced stretch, in percent.  A call's least time is the
larger of its needed bytes at the HBM rate and its operations at the
peak (perfbench/roofline/bounds.py, per step from the cell's shapes);
calls without a bound stay out of both sums."""

from .. import trace
from ._stretch import stretch


def read(run: dict, suffix: str):
    s = stretch(run, suffix)
    if s is None:
        return None
    secs = trace.class_seconds(run["events"], run["stretch_us"],
                               run["classes"])
    least = took = 0.0
    for call, per_step in run["bounds"].items():
        t = secs.get(f"port:{call}")
        if t:
            least += per_step * s[1]
            took += t
    return None if took <= 0 else 100.0 * least / took

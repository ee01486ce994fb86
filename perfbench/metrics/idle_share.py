"""Share of the traced stretch in which no kernel, memcpy or memset ran
on the device: 1 - (union of their intervals) / (the stretch's length)."""

from .. import trace
from ._stretch import stretch


def read(run: dict, suffix: str):
    s = stretch(run, suffix)
    if s is None:
        return None
    busy = trace.busy_us(trace.device_intervals(run["events"],
                                                run["stretch_us"])) / 1e6
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / s[0])

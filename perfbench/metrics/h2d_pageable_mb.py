"""Megabytes (1e6 bytes) copied to the card from pageable host memory per
step or request: the program's h2d.pageable_bytes counter over its
steps.train or requests.eval counter, both counted over the whole
process."""

from . import _program
from ._stretch import stretch


def read(run: dict, suffix: str):
    if stretch(run, suffix) is None:
        return None
    snap = _program.snapshot()
    if snap is None:
        return None
    counters = snap["counters"]
    n = counters.get(_program.STEP_COUNTER[run["kind"]], 0)
    if n <= 0:
        return None
    return counters.get("h2d.pageable_bytes", 0) / n / 1e6

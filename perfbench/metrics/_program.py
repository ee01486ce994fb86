"""What the readers of the program's spans and counters share.

The program keeps its counters and the device ms of its spans in one
registry (motionpriorcmax_tpu_torch/utils/profiling.py::snapshot).  Spans
are recorded only while a profiler is on, which in a cell's process is
the traced stretch alone; their host records are in the stretch's events.
A program without the registry, or a stretch whose step spans the program
did not count one for one, gives nothing to read."""

from .. import trace
from ._stretch import stretch

STEP_SPAN = {"train": "step.train", "eval": "step.eval"}
STEP_COUNTER = {"train": "steps.train", "eval": "requests.eval"}


def snapshot():
    try:
        from motionpriorcmax_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    return snapshot()


def span_ms_per_step(run: dict, suffix: str, names):
    """Device ms per step or request of the spans `names` together, or
    None unless each was timed and the registry holds as many step spans
    as the stretch ran."""
    if stretch(run, suffix) is None:
        return None
    snap = snapshot()
    if snap is None:
        return None
    spans = snap["spans"]
    steps = spans.get(STEP_SPAN[run["kind"]], {}).get("count", 0)
    if steps != run["stretch_steps"] or not all(
            spans.get(n, {}).get("device_ms") is not None for n in names):
        return None
    return sum(spans[n]["device_ms"] for n in names) / steps


def host_spans(run: dict, suffix: str, names):
    """((start, end) us of the stretch's host records of the spans
    `names`, clipped to the stretch), or None unless the stretch holds as
    many step spans as it ran steps."""
    if stretch(run, suffix) is None:
        return None
    lo, hi = run["stretch_us"]
    step = STEP_SPAN[run["kind"]]
    out, steps = [], 0
    for e in run["events"]:
        if e["device"]:
            continue
        a, b = max(e["start_us"], lo), min(e["start_us"] + e["dur_us"], hi)
        if e["name"] == step and b > a:
            steps += 1
        elif e["name"] in names and b > a:
            out.append((a, b))
    return out if steps == run["stretch_steps"] else None


def union(intervals):
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def idle_while(run: dict, intervals) -> float:
    """Microseconds of the stretch in which the device was idle and the
    host inside one of `intervals`."""
    gaps = trace.gaps(trace.device_intervals(run["events"], run["stretch_us"]),
                      run["stretch_us"])
    total = 0.0
    for a, b in union(intervals):
        for g0, g1 in gaps:
            total += max(0.0, min(b, g1) - max(a, g0))
    return total

"""The traced stretch of a run: torch.profiler (CPU and CUDA activities)
over a few whole steady steps inside the window, reduced in memory to
plain event records that the metric readers take.

An event is {"name", "device": bool, "start_us", "dur_us"}; device events
are the card's kernels, memcpys and memsets.  The stretch is the span of
the "perfbench.stretch" annotation, which ends with a synchronize, so it
covers the stretch's device work.  Nothing is written to disk.
"""

from __future__ import annotations

import contextlib
import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

STRETCH = "perfbench.stretch"
_CLASSES = Path(__file__).resolve().parent / "kernels" / "classes.json"


@contextlib.contextmanager
def profiled(device: str, out: dict):
    """Profile the body; on exit out["events"] holds the event records and
    out["stretch_us"] the stretch's (start, end)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(STRETCH):
            yield
            if device == "cuda":
                torch.cuda.synchronize()
    events, stretch = [], None
    for e in prof.profiler.kineto_results.events():
        rec = {"name": e.name(), "device": e.device_type().name != "CPU",
               "start_us": e.start_ns() / 1e3, "dur_us": e.duration_ns() / 1e3}
        if rec["name"] == STRETCH:
            # The annotation also shows on the device's timeline, spanning
            # its kernels: it is no device operation.
            if not rec["device"]:
                stretch = (rec["start_us"], rec["start_us"] + rec["dur_us"])
            continue
        events.append(rec)
    out["events"] = events
    out["stretch_us"] = stretch


def device_intervals(events: List[dict], stretch: Tuple[float, float]
                     ) -> List[Tuple[float, float, str]]:
    """Device events clipped to the stretch, sorted by start."""
    lo, hi = stretch
    out = []
    for e in events:
        if not e["device"]:
            continue
        a, b = max(e["start_us"], lo), min(e["start_us"] + e["dur_us"], hi)
        if b > a:
            out.append((a, b, e["name"]))
    return sorted(out)


def busy_us(intervals: List[Tuple[float, float, str]]) -> float:
    """Length of the union of the intervals."""
    total, end = 0.0, None
    for a, b, _ in intervals:
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals: List[Tuple[float, float, str]],
         stretch: Tuple[float, float]) -> List[Tuple[float, float]]:
    """Idle (start, end) spans of the device inside the stretch."""
    out, cur = [], stretch[0]
    for a, b, _ in intervals:
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if stretch[1] > cur:
        out.append((cur, stretch[1]))
    return out


def load_classes() -> dict:
    spec = json.loads(_CLASSES.read_text())
    spec["compiled"] = {k: [re.compile(p) for p in v]
                        for k, v in spec["patterns"].items()}
    return spec


def classify(name: str, spec: dict) -> Tuple[str, Optional[str]]:
    """('port', call) for the port's own kernels, (class, None) for a
    class of 'order', ('other', None) else."""
    for sym, call in spec["port"].items():
        if sym in name:
            return "port", call
    for cls in spec["order"]:
        if any(p.search(name) for p in spec["compiled"][cls]):
            return cls, None
    return "other", None


def class_seconds(events: List[dict], stretch: Tuple[float, float],
                  spec: dict) -> Dict[str, float]:
    """Device seconds by class, and by port call under 'port:<call>'."""
    out: Dict[str, float] = {}
    for a, b, name in device_intervals(events, stretch):
        cls, call = classify(name, spec)
        key = f"port:{call}" if cls == "port" else cls
        out[key] = out.get(key, 0.0) + (b - a) / 1e6
    return out


def breakdown(events: List[dict], stretch: Tuple[float, float],
              top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the innermost host operation the profiler saw running
    at their middle (none: the host ran Python or NumPy)."""
    per_op: Dict[str, float] = {}
    ivs = device_intervals(events, stretch)
    for a, b, name in ivs:
        per_op[name] = per_op.get(name, 0.0) + (b - a) / 1e6
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    host = [e for e in events if not e["device"]]
    named = []
    for a, b in sorted(gaps(ivs, stretch), key=lambda g: g[0] - g[1])[:top]:
        mid = (a + b) / 2.0
        inner = [e for e in host
                 if e["start_us"] <= mid <= e["start_us"] + e["dur_us"]]
        label = (min(inner, key=lambda e: e["dur_us"])["name"] if inner
                 else "no torch op (Python or NumPy on the host)")
        named.append([label, (b - a) / 1e6])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}

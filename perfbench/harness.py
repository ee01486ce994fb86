"""One run of one cell, found by name: set-up, the measured window, the
traced stretch (with --trace 1), the comparison with the reference, the
metrics.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own, found by the names in BENCHMARK.json:
  configs/<config>.json      the configuration as it is run (the cell's
                             "config" names the entry whose "file" it is)
  traffic/<traffic>.json     the mix's parameters; its "generator" names
                             perfbench/generators/<generator>.py
  limits/<cell>.json         the limit of each number compared
  metrics/<base>.py          the reader of metric <base>[.<suffix>]
"""

from __future__ import annotations

import importlib
import json
import math
import time
from pathlib import Path
from typing import Dict, Optional

from . import trace as tracing

ROOT = Path(__file__).resolve().parent.parent


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_files(bench: dict, cell: dict):
    """(configuration, traffic mix, limits) of a cell, from their files."""
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    here = Path(__file__).resolve().parent
    traffic = json.loads((here / "traffic" / f"{cell['traffic']}.json"
                          ).read_text())
    limits = json.loads((here / "limits" / f"{cell['name']}.json").read_text())
    return config, traffic, limits


def cell_metrics(bench: dict, cell: str, traced: bool):
    """The metrics a run of `cell` reports: the end-to-end ones, or with a
    trace the per-layer ones, that list the cell or list no cells."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metric(metric: dict, run: dict) -> Optional[float]:
    base, _, suffix = metric["name"].partition(".")
    reader = importlib.import_module(f"perfbench.metrics.{base}")
    return reader.read(run, suffix)


def _sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             traced: bool, device: str = "cuda",
             t0: Optional[float] = None) -> dict:
    """The result line of one run (without its JSON encoding), plus
    'details' (the comparison's other readings) for standard error."""
    t0 = time.perf_counter() if t0 is None else t0
    return run_loaded(bench, cell, *cell_files(bench, cell), seed, seconds,
                      traced, device, t0)


def run_loaded(bench: dict, cell: dict, config: dict, traffic: dict,
               limits: dict, seed: int, seconds: float, traced: bool,
               device: str, t0: float) -> dict:
    """run_cell on a configuration, mix and limits already read."""
    import torch

    mod = importlib.import_module(
        f"perfbench.generators.{traffic['generator']}")
    cell_run = mod.CellRun(config, traffic, seed, device)
    run: Dict[str, object] = {
        "kind": cell_run.kind, "flops_per_step": cell_run.model_flops(),
        "peak_flops": float(config["peak_flops"]),
        "bounds": cell_run.launch_bounds(),
        "samples_per_step": cell_run.samples_per_step}
    _sync(device)
    run["setup_s"] = time.perf_counter() - t0

    latencies, steps, stretch_steps, out = [], 0, 0, {}
    start = time.perf_counter()
    while True:
        if traced and steps == 1 and not out:
            _sync(device)
            stretch_steps = int(traffic["trace_steps"])
            with tracing.profiled(device, out):
                for _ in range(stretch_steps):
                    latencies.append(cell_run.step())
            steps += stretch_steps
        latencies.append(cell_run.step())
        steps += 1
        if time.perf_counter() - start >= seconds:
            break
    _sync(device)
    run["window_s"] = time.perf_counter() - start
    run["steps"] = steps
    run["samples"] = steps * cell_run.samples_per_step
    run["latencies_ms"] = [x for x in latencies if x is not None]
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
    if out:
        run.update(events=out["events"], stretch_us=out["stretch_us"],
                   stretch_steps=stretch_steps,
                   classes=tracing.load_classes())

    details = cell_run.check()
    compared = {k: {"value": float(details[k]), "limit": float(v)}
                for k, v in limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in compared.values())

    metrics = {}
    for m in cell_metrics(bench, cell["name"], traced):
        value = read_metric(m, run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": steps, "failed": 0,
              "metrics": metrics, "device": dev}
    if out:
        ivs = tracing.device_intervals(out["events"], out["stretch_us"])
        dev["busy_s"] = tracing.busy_us(ivs) / 1e6
        dev["window_s"] = (out["stretch_us"][1] - out["stretch_us"][0]) / 1e6
        result["breakdown"] = tracing.breakdown(out["events"],
                                                out["stretch_us"])
    result["compared"] = compared
    result["details"] = {k: v for k, v in details.items() if k not in limits}
    return result

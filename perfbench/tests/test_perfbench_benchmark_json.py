"""BENCHMARK.json against the benchmark contract's rules on names, units,
files and references between entries."""

import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
               for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32
    assert all(TEXT.match(w) and not w.startswith("/")
               for w in BENCH["command"])


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert all(NAME.match(n) for n in names), names
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    cells = [w["name"] for w in BENCH["workloads"]]
    assert len(cells) == len(set(cells))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16


def test_workloads_have_their_files():
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert TEXT.match(w["why"])
        assert NAME.match(w["traffic"])
        traffic_file = ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json"
        assert traffic_file.is_file()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").is_file()
        traffic = json.loads((ROOT / "perfbench" / "traffic"
                              / f"{w['traffic']}.json").read_text())
        importlib.import_module(f"perfbench.generators.{traffic['generator']}")


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric(metric):
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(metric["workloads"]) <= cells if "workloads" in metric else True
    base = metric["name"].partition(".")[0]
    assert hasattr(importlib.import_module(f"perfbench.metrics.{base}"),
                   "read")
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert TEXT.match(metric["layer"])
        assert metric["moves"] in e2e
        moved = next(m for m in BENCH["end_to_end"]
                     if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))


def test_every_cell_reports_enough():
    e2e, per = BENCH["end_to_end"], BENCH["per_layer"]
    for w in BENCH["workloads"]:
        def reported(group):
            return [m["name"] for m in group
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in reported(e2e)
        assert len(reported(e2e)) >= 2
        assert reported(per)

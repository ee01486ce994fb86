"""A configuration, a traffic mix, a cell and a per-layer metric added by
new files and new entries only, in a copy of the benchmark, are found by
name and run (on the CPU at a tiny size), with no file edited but
BENCHMARK.json."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN = """
import json, sys, time
from perfbench import harness
bench = harness.load_benchmark()
cell = harness.find_cell(bench, "dsec-unet-tiny.train-softmax-small")
out = {}
for traced in (False, True):
    res = harness.run_cell(bench, cell, 2**31 + 7, 0.3, traced, "cpu",
                           time.perf_counter())
    out[str(traced)] = sorted(res["metrics"])
    out["correct"] = res["correct"]
print(json.dumps(out))
"""


def test_a_cell_added_from_files_only(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "perfbench"

    config = json.loads((pb / "configs" / "dsec-unet.json").read_text())
    config["name"] = "dsec-unet-tiny"
    config["tree"]["common"].update(height=64, width=96)
    config["tree"]["data"]["batch_size"] = 2
    config["tree"]["model"]["unet_widths"] = [8, 16, 16, 32, 32]
    (pb / "configs" / "dsec-unet-tiny.json").write_text(json.dumps(config))
    traffic = json.loads((pb / "traffic" / "flow-train-softmax.json"
                          ).read_text())
    traffic.update(events=4096, capacity=8192, trace_steps=1)
    (pb / "traffic" / "flow-train-softmax-small.json").write_text(
        json.dumps(traffic))
    (pb / "limits" / "dsec-unet-tiny.train-softmax-small.json").write_text(
        json.dumps({"loss_gap": 1.0, "grad_gap": 10.0, "update_gap": 10.0}))
    (pb / "metrics" / "samples_per_step.py").write_text(
        "def read(run, suffix):\n    return run['samples_per_step']\n")

    cell = "dsec-unet-tiny.train-softmax-small"
    bench["configs"].append({
        "name": "dsec-unet-tiny", "source": "a test", "reduced": [],
        "file": "perfbench/configs/dsec-unet-tiny.json", "why": "a test"})
    bench["workloads"].append({
        "name": cell, "config": "dsec-unet-tiny",
        "traffic": "flow-train-softmax-small", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append(cell)
    bench["per_layer"].append({
        "name": "samples_per_step", "unit": "samples", "better": "higher",
        "source": "program_counter", "layer": "Step",
        "moves": "train_samples_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", RUN], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["False"] == ["setup_s", "train_samples_per_s"]
    assert "samples_per_step" in got["True"]
    assert got["correct"] is True

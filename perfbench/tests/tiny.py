"""The benchmark's cells cut to sizes a CPU test run holds: the same
code paths, 64 x 96 (DSEC) or 64 x 64 (EVIMO2) pixels, batch 2, a
narrow UNet, one RAFT iteration, a few thousand events."""

from __future__ import annotations

import copy

import time

from perfbench import harness


def tiny_cell(name: str):
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, name)
    config, traffic, limits = harness.cell_files(bench, cell)
    config, traffic = copy.deepcopy(config), dict(traffic)
    tree = config["tree"]
    if config["name"] == "dsec-unet":
        tree["common"].update(height=64, width=96)
        tree["data"]["batch_size"] = 2
        tree["model"]["unet_widths"] = [8, 16, 16, 32, 32]
        traffic.update(events=4096, capacity=8192)
    else:
        config.update(height=64, width=64)
        tree["model"]["num_iter"] = {"train": 1, "test": 1}
        tree["training"]["batch_size"] = 2
        tree["batch_size"] = 2
        if "events" in traffic:
            traffic.update(events=2048, capacity=4096)
        traffic["check_among"] = 4
    return bench, cell, config, traffic, limits


def run_tiny(name: str, seed: int = 1234567890123, traced: bool = False,
             seconds: float = 0.5):
    bench, cell, config, traffic, limits = tiny_cell(name)
    return harness.run_loaded(bench, cell, config, traffic, limits, seed,
                              seconds, traced, "cpu", time.perf_counter())

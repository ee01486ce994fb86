"""The control of a cell's comparison: the reference put in the program's
place, one precision step below what the configuration states (its
"control_precision": fp8 convolutions for the bf16 UNet, TF32 for the f32
RAFT-Spline), compared with the reference at the stated precision by the
cell's own numbers.  It has to come out as not correct.

    python3 -m perfbench.control --workload <cell> --seeds 11,12,13

One line per seed: the numbers and the cell's limits.  Training needs no
window (the numbers are of the first steps); an evaluation cell compares
the pool batches its picked requests use.  The benchmark's runs never
call this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys


def control_numbers(config: dict, traffic: dict, seed: int,
                    device: str) -> dict:
    from .generators import common

    mod = importlib.import_module(
        f"perfbench.generators.{traffic['generator']}")
    cell_run = mod.CellRun(config, traffic, seed, device, program=False)
    if cell_run.kind == "train":
        low = cell_run.reference_run("control")
        ref = cell_run.reference_run("stated")
        return common.training_numbers(low[0], ref[0], low[1], ref[1],
                                       low[2], ref[2])
    picked = sorted(cell_run.picked)
    low = cell_run.reference_answers("control", picked)
    ref = cell_run.reference_answers("stated", picked)
    params_gap = max(float((low[j][0].double() - ref[j][0].double()).norm()
                           / ref[j][0].double().norm()) for j in ref)
    epe_gap = max(abs(float(low[j][1]) - float(ref[j][1]))
                  / abs(float(ref[j][1])) for j in ref)
    return {"params_gap": params_gap, "epe_gap": epe_gap}


def main(argv=None) -> int:
    from . import harness

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    config, traffic, limits = harness.cell_files(bench, cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        nums = control_numbers(config, traffic, seed, args.device)
        line = {k: {"value": float(nums[k]), "limit": v}
                for k, v in limits.items()}
        line["fails"] = any(not (c["value"] <= c["limit"])
                            for c in line.values())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": line}))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

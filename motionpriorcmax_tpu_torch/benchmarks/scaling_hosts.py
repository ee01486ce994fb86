"""The multi-process training path at N processes (JAX:
benchmarks/scaling_hosts.py with the train_flow part of
tests/_distributed_worker.py).

    python -m motionpriorcmax_tpu_torch.benchmarks.scaling_hosts
        [--worlds 1,2,4] [--device cpu]

Each N is a world of N processes of this module on this host, mesh (N, 1):
every rank loads its shard of the same 4 deterministic 16x16 samples (3
bins, 256 events, GT flow), a global batch of 4, and runs train_flow for
one epoch (one step, then the validation pass whose metric sums are
reduced over the ranks).  Each world must reproduce the world of one's
best validation metric.  Ranks run on the card unless given --device cpu:
over NCCL when each has its own card, over gloo when they share one.
Prints a line naming the device, one JSON line per world with its
best_val, steps and wall time (every rank's best must agree), and the
parity verdict: every world within 5e-3 of the world of one.  Exits
non-zero when the verdict is false.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from . import bench_device, device_line, run_world, world_backend

MODULE = "motionpriorcmax_tpu_torch.benchmarks.scaling_hosts"
WORLDS = (1, 2, 4)
WORLD_TIMEOUT_S = 600
PARITY_ATOL = 5e-3
H, W, NBINS, N_EV = 16, 16, 3, 256
GLOBAL_BATCH = 4


class SyntheticDataset:
    """4 deterministic samples, the same in every process."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        rng = np.random.default_rng(100 + i)
        y = rng.uniform(0, H - 1, N_EV)
        x = rng.uniform(0, W - 1, N_EV)
        t = rng.uniform(0, 1, N_EV)
        p = rng.integers(0, 2, N_EV).astype(np.float32)
        b = np.clip((t * NBINS).astype(np.int32), 0, NBINS - 1)
        events = np.stack([y, x, t, p, b], -1).astype(np.float32)
        gt = rng.normal(size=(2, H, W)).astype(np.float32)
        valid = rng.uniform(size=(H, W)) < 0.8
        return {"events": events, "forward_flow": gt,
                "flow_valid": valid.astype(np.float32)}


def rank_main(args: argparse.Namespace) -> None:
    """One rank: train_flow over its shards; writes {'best', 'steps'} to
    <workdir>/out_n<N>_p<rank>.json."""
    import torch.distributed as dist

    from ..data.loader import DataLoader
    from ..losses import FocusLossConfig
    from ..parallel import initialize_distributed, make_mesh
    from ..training.loop import train_flow
    from ..training.trajectory_net import TrajectoryNetConfig

    n, rank = args.world, args.rank
    # No TensorBoard mirror of the scalars: importing it (TensorFlow, where
    # installed) takes longer than the world's one step and validation.
    sys.modules["torch.utils.tensorboard"] = None
    if args.device == "cpu" and "OMP_NUM_THREADS" not in os.environ:
        # The ranks share the host's cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    dev = initialize_distributed(
        f"127.0.0.1:{args.port}", n, rank,
        backend=world_backend(args.device, n), device=args.device,
        timeout_s=WORLD_TIMEOUT_S)
    try:
        mesh = make_mesh(n, 1)
        kw = dict(batch_size=GLOBAL_BATCH // n, capacity=N_EV,
                  shuffle=False, num_workers=1, shard=(rank, n))
        ds = SyntheticDataset()
        cfg = TrajectoryNetConfig(image_shape=(H, W), num_bins=NBINS,
                                  num_basis=1, patch_size=4,
                                  basis_type="polynomial")
        loss_cfg = FocusLossConfig(image_shape=(H, W), num_bins=NBINS,
                                   num_knn=4, polarity_aware_batching=False,
                                   knn_block_size=64)
        res = train_flow(cfg, loss_cfg, DataLoader(ds, **kw),
                         DataLoader(ds, **kw, equal_batches=False),
                         os.path.join(args.workdir, f"run_n{n}"), device=dev,
                         max_epochs=1, log_every=1, mesh=mesh)
    finally:
        dist.destroy_process_group()
    Path(args.workdir, f"out_n{n}_p{rank}.json").write_text(
        json.dumps({"best": res["best"], "steps": res["steps"]}))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog=f"python -m {MODULE}", description=__doc__.split("\n\n")[0])
    ap.add_argument("--worlds", default=",".join(map(str, WORLDS)),
                    help="comma-separated world sizes (1, 2, 4: divisors "
                         f"of the global batch {GLOBAL_BATCH})")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; exits without a card) or cpu")
    # A rank of a world (run_world passes these).
    for flag in ("--rank", "--world", "--port"):
        ap.add_argument(flag, type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--workdir", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """{'worlds': [per-world records], 'parity_vs_single_process': bool,
    'best_vals': {N: best}}; exits non-zero unless the verdict holds."""
    args = parse_args(argv)
    if args.rank is not None:
        rank_main(args)
        return {}
    dev = bench_device(args.device, "scaling_hosts")
    print(device_line(dev), flush=True)
    worlds = [int(v) for v in args.worlds.split(",")]
    if 1 not in worlds or any(GLOBAL_BATCH % n for n in worlds):
        raise SystemExit(f"scaling_hosts: --worlds {args.worlds} needs 1 "
                         f"and divisors of {GLOBAL_BATCH}")
    records, bests = [], {}
    with tempfile.TemporaryDirectory() as workdir:
        for n in worlds:
            t0 = time.perf_counter()
            run_world(MODULE, n, ["--device", dev.type, "--workdir",
                                  workdir], WORLD_TIMEOUT_S)
            wall = time.perf_counter() - t0
            outs = [json.loads(Path(workdir, f"out_n{n}_p{r}.json")
                               .read_text()) for r in range(n)]
            # Every rank must hold the same reduced validation metric.
            agreed = {round(o["best"], 6) for o in outs}
            if len(agreed) != 1:
                raise SystemExit(f"scaling_hosts: the ranks of the world of "
                                 f"{n} disagree on best_val: {agreed}")
            bests[n] = outs[0]["best"]
            rec = {"hosts": n, "devices": n, "best_val": round(bests[n], 6),
                   "steps": outs[0]["steps"], "wall_s": round(wall, 1)}
            print(json.dumps(rec), flush=True)
            records.append(rec)
    ref = bests[1]
    ok = all(abs(b - ref) < PARITY_ATOL for b in bests.values())
    verdict = {"parity_vs_single_process": ok,
               "best_vals": {n: round(b, 6) for n, b in bests.items()}}
    print(json.dumps(verdict), flush=True)
    if not ok:
        raise SystemExit("scaling_hosts: a world's best_val is more than "
                         f"{PARITY_ATOL} from the world of one's")
    return {"worlds": records, **verdict}


if __name__ == "__main__":
    main()

"""Scaling of the sharded flow train step (JAX: benchmarks/scaling.py).

    python -m motionpriorcmax_tpu_torch.benchmarks.scaling [--virtual N]
        [--hw H W] [--events M] [--iters I] [--device cpu]

The port's mesh is one process per rank, so each world size s in 1, 2, 4,
8, ... is a world of s processes of this module on this host, each running
`bench_mesh` at mesh (s, 1): parallel/mesh.py's make_mesh, replicate and
shard_batch, and training/trajectory_net.py::train_step(mesh=) on one
sample of 2^19 events per rank (the default-width UNet, exact KNN).
Without --virtual, s runs up to the number of cards, over NCCL; with
--virtual N, up to N gloo ranks on the CPU (2^17 events per rank), which
checks the sharded program and measures no speed.  Prints a line naming
the device, then rank 0's {"metric": "scaling_events_per_s", "devices":
s, "value": events/s, "efficiency": events/s / (s x the world of one's)}
of each world.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils.profiling import device_timer
from . import bench_device, device_line, run_world, world_backend

MODULE = "motionpriorcmax_tpu_torch.benchmarks.scaling"
WORLD_TIMEOUT_S = 900


def bench_mesh(mesh, device, per_shard_batch: int = 1, m: int = 1 << 17,
               hw=(480, 640), nbins: int = 15, iters: int = 5) -> float:
    """Events per second of the global batch (mesh.data x per_shard_batch
    samples of m events, numpy seed 0) through the sharded flow train
    step, one warm-up step and `iters` timed ones."""
    from ..losses import FocusLossConfig
    from ..parallel import replicate, shard_batch
    from ..training.loop import to_device
    from ..training.trajectory_net import (TrajectoryNetConfig,
                                           create_train_state, train_step)

    h, w = hw
    cfg = TrajectoryNetConfig(image_shape=(h, w), num_bins=nbins)
    loss_cfg = FocusLossConfig(image_shape=(h, w), num_bins=nbins,
                               polarity_aware_batching=False,
                               knn_block_size=1200)
    batch = mesh.data * per_shard_batch
    rng = np.random.default_rng(0)
    y = rng.uniform(0, h - 1, (batch, m))
    x = rng.uniform(0, w - 1, (batch, m))
    t = rng.uniform(0, 1, (batch, m))
    p = rng.integers(0, 2, (batch, m)).astype(np.float32)
    bn = np.clip((t * nbins).astype(np.int32), 0, nbins - 1)
    events = np.stack([y, x, t, p, bn, np.ones((batch, m))],
                      -1).astype(np.float32)
    voxel = rng.normal(size=(batch, nbins, h, w)).astype(np.float32)

    state = replicate(mesh, create_train_state(
        cfg, device, torch.Generator().manual_seed(0)))
    local = to_device(shard_batch(mesh, {"voxel": voxel, "events": events}),
                      device)
    gen = torch.Generator().manual_seed(1)
    dt, _ = device_timer(
        lambda b: train_step(state, b, gen, cfg, loss_cfg, -1,
                             mesh=mesh)["train_losses/total"],
        local, iters=iters, warmup=1)
    return batch * m / dt


def rank_main(args: argparse.Namespace) -> None:
    """One rank of a world: bench_mesh at (world, 1); rank 0 prints the
    world's record."""
    import torch.distributed as dist

    from ..parallel import initialize_distributed, make_mesh

    if args.device == "cpu" and "OMP_NUM_THREADS" not in os.environ:
        # The ranks share the host's cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.world))
    dev = initialize_distributed(
        f"127.0.0.1:{args.port}", args.world, args.rank,
        backend=world_backend(args.device, args.world), device=args.device,
        timeout_s=WORLD_TIMEOUT_S)
    try:
        eps = bench_mesh(make_mesh(args.world, 1), dev, m=args.events,
                         hw=tuple(args.hw), iters=args.iters)
    finally:
        dist.destroy_process_group()
    if args.rank == 0:
        base = args.base or eps
        print(json.dumps({"metric": "scaling_events_per_s",
                          "devices": args.world, "value": round(eps, 0),
                          "efficiency": round(eps / (base * args.world), 3)}),
              flush=True)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog=f"python -m {MODULE}", description=__doc__.split("\n\n")[0])
    ap.add_argument("--virtual", type=int, default=0,
                    help="worlds of up to N gloo ranks on the CPU")
    ap.add_argument("--hw", type=int, nargs=2, default=(480, 640))
    ap.add_argument("--events", type=int, default=None,
                    help="events per rank (2^19; 2^17 with --virtual)")
    ap.add_argument("--iters", type=int, default=5,
                    help="timed steps per world, after one warm-up step")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; exits without a card) or cpu")
    # A rank of a world (run_world passes these).
    for flag in ("--rank", "--world", "--port"):
        ap.add_argument(flag, type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--base", type=float, default=None,
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    args = parse_args(argv)
    if args.rank is not None:
        rank_main(args)
        return []
    if args.virtual:
        args.device = "cpu"
    dev = bench_device(args.device, "scaling")
    print(device_line(dev), flush=True)
    if args.events is None:
        args.events = 1 << (17 if args.virtual else 19)
    n = (args.virtual if args.virtual else
         torch.cuda.device_count() if dev.type == "cuda" else 1)
    records, base = [], None
    for s in (1, 2, 4, 8, 16, 32):
        if s > n:
            break
        worker = ["--device", dev.type, "--hw", *map(str, args.hw),
                  "--events", str(args.events), "--iters", str(args.iters)]
        if base is not None:
            worker += ["--base", repr(base)]
        out = run_world(MODULE, s, worker, WORLD_TIMEOUT_S)[0]
        recs = [json.loads(line) for line in out.splitlines()
                if line.startswith('{"metric": "scaling_events_per_s"')]
        if not recs:
            raise SystemExit(f"scaling: rank 0 of the world of {s} printed "
                             f"no record:\n{out[-4000:]}")
        rec = recs[-1]
        base = base or rec["value"]
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()

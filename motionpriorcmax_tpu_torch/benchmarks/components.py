"""Component microbenchmarks of the port's hot ops (JAX:
benchmarks/components.py).

    python -m motionpriorcmax_tpu_torch.benchmarks.components [--device cpu]

Prints a line naming the device, then one JSON line per component,
{"metric": key, "value": v}, under the JAX module's key names:

  knn_exact_b2x15_19200x19200_k32_ms, knn_approx_ms, knn_grid_ms
      ops/knn.py (plain PyTorch): 19,200 queries against b x 15 databases
      of 19,200 points, K=32
  iwe_scatter_direct_events_per_s, iwe_scatter_fwd_bwd_events_per_s
      ops/events.py::iwe_bilinear_vote_batch, and its gradient with
      respect to the coordinates: the IWE-vote kernels on events in any
      order (row 4)
  voxelize_events_per_s
      training/trajectory_net.py::voxelize_batch_on_device, what
      --device-voxelize runs: the voxel-vote kernel (row 8), then the
      mean_std normalization
  focus_loss_exact_fwd_events_per_s, focus_loss_exact_fwd_bwd_events_per_s
      losses/focus.py::focus_loss with the exact KNN, forward, and its
      gradient with respect to the trajectories (the vote, row 4; the
      LUT gather's backward on events in any order, row 5)
  focus_loss_softmax_fwd_bwd_events_per_s
      the same with knn_method softmax (rows 4, 5 and 7)
  focus_loss_sorted_fwd_bwd_events_per_s
      the softmax loss on events cell-sorted by data/host_ops.py::
      lut_cell_sort, with their cell ends (rows 3, 6 and 7)

at 480x640, 15 bins, K=32, b=2 and 2^19 events per sample, drawn from
numpy seed 0 in the JAX module's order.  Three JAX keys are left out:
iwe_scatter_sorted_events_per_s, iwe_matmul_events_per_s and
iwe_matmul_fwd_bwd_events_per_s time the TPU's scatter layouts
(`scatter_impl` 'sorted' and 'matmul'); the port's vote is one function
with one implementation, the kernel behind the 'direct' key.  A case that
fails raises (the JAX module prints -1 for a failing grid KNN).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..utils.profiling import device_timer
from . import bench_device, device_line

SIZES = dict(h=480, w=640, nbins=15, k=32, b=2, m=1 << 19)
ITERS = 5


@dataclasses.dataclass
class Case:
    """`fn(*args)` is timed; `events` per call gives events/s, None ms."""

    fn: Callable
    args: tuple
    events: Optional[int]


def build_cases(device, h: int, w: int, nbins: int, k: int, b: int, m: int,
                seed: int = 0) -> Dict[str, Case]:
    """Every timed case at these sizes, its inputs on `device`, keyed by
    its metric; the numpy draws are the JAX module's, in its order."""
    from ..data.host_ops import lut_cell_sort
    from ..losses import FocusLossConfig, focus_loss
    from ..ops.events import iwe_bilinear_vote_batch
    from ..ops.grids import tile_mask_positions
    from ..ops.knn import knn_blocked, knn_grid_window
    from ..training.trajectory_net import (TrajectoryNetConfig,
                                           voxelize_batch_on_device)

    rng = np.random.default_rng(seed)

    def put(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    cases = {}
    # KNN: the (h/4) x (w/4) grid's points, per (sample, bin).
    q = (h // 4) * (w // 4)
    queries = put(rng.uniform(0, h, (q, 2)))
    db = put(rng.uniform(0, h, (b * nbins, q, 2)))
    cases["knn_exact_b2x15_19200x19200_k32_ms"] = Case(
        lambda d: knn_blocked(queries, d, k), (db,), None)
    cases["knn_approx_ms"] = Case(
        lambda d: knn_blocked(queries, d, k, method="approx"), (db,), None)
    cases["knn_grid_ms"] = Case(
        lambda d: knn_grid_window(queries, d, k, cell_size=4.0,
                                  grid_hw=(h // 4, w // 4), window_radius=6,
                                  cell_capacity=6), (db,), None)

    # The IWE vote, forward and forward + backward.
    coords = put(rng.uniform(0, h - 1, (b, m, 2)))
    wgt = torch.ones((b, m), device=device)
    vote = functools.partial(iwe_bilinear_vote_batch, height=h, width=w)

    def vote_grad(c, wg):
        c = c.detach().requires_grad_(True)
        img = vote(c, wg)
        return torch.autograd.grad((img * img).sum(), c)[0]

    cases["iwe_scatter_direct_events_per_s"] = Case(vote, (coords, wgt),
                                                     b * m)
    cases["iwe_scatter_fwd_bwd_events_per_s"] = Case(vote_grad,
                                                      (coords, wgt), b * m)

    # The voxel grid of one sample's events (t_norm in bins, as JAX draws
    # it; the port's events carry t in [0, 1]).
    y = rng.uniform(0, h - 1, (m,))
    x = rng.uniform(0, w - 1, (m,))
    t = rng.uniform(0, nbins - 1, (m,))
    p = rng.integers(0, 2, (m,))
    vox_events = put(np.stack([y, x, t / (nbins - 1), p, np.floor(t),
                               np.ones(m)], -1)[None])
    vcfg = TrajectoryNetConfig(image_shape=(h, w), num_bins=nbins)
    cases["voxelize_events_per_s"] = Case(
        lambda ev: voxelize_batch_on_device(vcfg, ev), (vox_events,), m)

    # The focus loss, no model: trajectories at the tile centres.
    loss_cfg = FocusLossConfig(image_shape=(h, w), num_bins=nbins,
                               num_knn=k, polarity_aware_batching=False,
                               knn_block_size=1200)
    soft_cfg = dataclasses.replace(loss_cfg, knn_method="softmax",
                                   knn_block_size=512)
    pos = tile_mask_positions((h, w), 4).astype(np.float32)
    times = put(np.concatenate([[0.5], (np.arange(nbins) + 0.5) / nbins]))
    traj = put(np.broadcast_to(pos[None, None],
                               (b, nbins + 1) + pos.shape))
    bins = rng.integers(0, nbins, (b, m))
    events_np = np.stack([
        rng.uniform(0, h - 1, (b, m)), rng.uniform(0, w - 1, (b, m)),
        rng.uniform(0, 1, (b, m)), rng.integers(0, 2, (b, m)), bins,
        np.ones((b, m))], -1).astype(np.float32)
    events = put(events_np)

    def loss_fwd(tr, ev):
        with torch.no_grad():
            return focus_loss(loss_cfg, tr, times, ev)[0]

    def loss_grad(cfg, tr, ev, ends=None):
        tr = tr.detach().requires_grad_(True)
        loss = focus_loss(cfg, tr, times, ev, cell_ends=ends)[0]
        return torch.autograd.grad(loss, tr)[0]

    cases["focus_loss_exact_fwd_events_per_s"] = Case(
        loss_fwd, (traj, events), b * m)
    cases["focus_loss_exact_fwd_bwd_events_per_s"] = Case(
        functools.partial(loss_grad, loss_cfg), (traj, events), b * m)
    cases["focus_loss_softmax_fwd_bwd_events_per_s"] = Case(
        functools.partial(loss_grad, soft_cfg), (traj, events), b * m)
    pairs = [lut_cell_sort(events_np[i], (h, w), nbins, 4) for i in range(b)]
    ev_sorted = put(np.stack([pp[0] for pp in pairs]))
    ends = torch.from_numpy(np.stack([pp[1] for pp in pairs])).to(device)
    cases["focus_loss_sorted_fwd_bwd_events_per_s"] = Case(
        functools.partial(loss_grad, soft_cfg), (traj, ev_sorted, ends),
        b * m)
    return cases


def run(device, iters: int = ITERS, **sizes) -> Dict[str, float]:
    """Time every case at `sizes` (SIZES by default) on `device`, print the
    device line and one JSON line per metric; returns {metric: value}."""
    dev = torch.device(device)
    print(device_line(dev), flush=True)
    results = {}
    for key, case in build_cases(dev, **{**SIZES, **sizes}).items():
        dt, _ = device_timer(case.fn, *case.args, iters=iters)
        results[key] = (round(dt * 1e3, 2) if case.events is None
                        else round(case.events / dt, 0))
        print(json.dumps({"metric": key, "value": results[key]}),
              flush=True)
    return results


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(
        prog="python -m motionpriorcmax_tpu_torch.benchmarks.components",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; exits without a card) or cpu")
    args = ap.parse_args(argv)
    return run(bench_device(args.device, "components"))


if __name__ == "__main__":
    main()

"""Synthetic inputs from the seed: copies of `chip_smoke.py`'s generators
(`flow_samples`, `traj_samples`), each drawing from the caller's numpy
generator.  Every seed gives the same sizes: a fixed number of events per
window and of samples per batch; only positions, times, polarities and
values move."""

from __future__ import annotations

import numpy as np


def flow_samples(rng, n_samples: int, n_events: int, h: int, w: int,
                 nb: int, voxel: bool = True):
    """DSEC-like windows: uniform float pixel coordinates, sorted
    normalized times, random polarity, the bin of each time; with `voxel`
    the host voxel grid the loader would give (the port's host op)."""
    from motionpriorcmax_tpu_torch.data.host_ops import (
        voxelize_normalized_host)

    edges = np.linspace(0, 1, nb + 1)
    samples = []
    for _ in range(n_samples):
        t = np.sort(rng.random(n_events))
        ev = np.stack([rng.random(n_events) * (h - 1),
                       rng.random(n_events) * (w - 1), t,
                       rng.integers(0, 2, n_events),
                       np.clip(np.searchsorted(edges, t) - 1, 0, None)],
                      -1).astype(np.float32)
        s = {"pos_events": ev[ev[:, 3] == 1], "neg_events": ev[ev[:, 3] == 0]}
        if voxel:
            s["voxel"] = voxelize_normalized_host(ev, nb, h, w)
        samples.append(s)
    return samples


def traj_samples(rng, n: int, h: int, w: int, nbins_total: int,
                 context_bins: int, events: int = 0, gt_steps: int = 6,
                 density: float = 0.3):
    """EVIMO2-shaped samples: a normalized voxel grid with `density` of
    its entries nonzero, GT flow (x, y) at `gt_steps` timestamps with a
    validity mask; with `events`, that many raw events (uniform positions,
    sorted times, random polarity, the context-bin index) in polarity
    halves."""
    edges = np.linspace(0, 1, context_bins + 1)
    samples = []
    for _ in range(n):
        ev_repr = rng.standard_normal((nbins_total, h, w), dtype=np.float32)
        ev_repr *= rng.random((nbins_total, h, w), dtype=np.float32) < density
        s = {"ev_repr": ev_repr,
             "flow": 5 * rng.standard_normal((gt_steps, 2, h, w),
                                             dtype=np.float32),
             "flow_timestamps": np.linspace(0, 1, gt_steps + 1)[1:].astype(
                 np.float32),
             "flow_valid": rng.random((gt_steps, h, w)) > 0.2}
        if events:
            t = np.sort(rng.random(events))
            ev = np.stack([rng.random(events) * (h - 1),
                           rng.random(events) * (w - 1), t,
                           rng.integers(0, 2, events),
                           np.clip(np.searchsorted(edges, t) - 1, 0, None)],
                          -1).astype(np.float32)
            s["pos_events"] = ev[ev[:, 3] == 1]
            s["neg_events"] = ev[ev[:, 3] == 0]
        samples.append(s)
    return samples


def live_counts(pool) -> tuple:
    """Valid events of each polarity half of a pool's batches, on
    average over the batches."""
    pos = neg = 0
    for batch in pool:
        ev, npos = batch["events"], int(batch["num_pos_events"])
        pos += int(ev[:, :npos, 5].sum())
        neg += int(ev[:, npos:, 5].sum())
    return pos / len(pool), neg / len(pool)

"""Fixed-capacity batching of ragged event streams (JAX: data/collate.py).

Events are padded (or tail-truncated) to a static capacity, with the 6th
'valid' column marking real rows.  Polarity-aware batching packs positives
first at a static positive capacity (capacity // 2 by default).  With
capacity buckets (the loader's) a batch pads to the smallest bucket that
covers its largest sample instead (`bucket_capacities`).  With
`lut_cell_sort_params` events are sorted by flow-LUT cell within each
polarity segment and the batch carries 'lut_cell_ends'.  Each sample's
share (`prepare_sample`) is apart from the stack (`stack_samples`), so the
loader runs it on its pool threads.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def round_up_capacity(n: int, buckets: Sequence[int]) -> int:
    """The smallest bucket >= n; the last bucket when none is (the
    overflow is then tail-truncated)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def bucket_capacities(samples: Sequence[Dict[str, np.ndarray]],
                      buckets: Sequence[int], polarity_aware: bool = False
                      ) -> Tuple[int, Optional[int]]:
    """(capacity, pos_capacity) of a batch under ascending capacity buckets:
    the smallest bucket covering the batch's largest sample or, with
    polarity_aware, each polarity half from the buckets halved (its
    positives' and its negatives' largest count each), the capacity being
    their sum; pos_capacity is None without polarity_aware."""
    if polarity_aware:
        half = [b // 2 for b in buckets]
        pos = round_up_capacity(max(len(s["pos_events"]) for s in samples),
                                half)
        neg = round_up_capacity(max(len(s["neg_events"]) for s in samples),
                                half)
        return pos + neg, pos
    return round_up_capacity(max(len(s["events"]) for s in samples),
                             buckets), None


def pad_events(events: np.ndarray, capacity: int) -> np.ndarray:
    """[n, 5] (y, x, t, p, bin) -> [capacity, 6] with the valid column;
    events beyond capacity are dropped from the tail."""
    n = min(len(events), capacity)
    out = np.zeros((capacity, 6), dtype=np.float32)
    out[:n, :5] = events[:n, :5]
    out[:n, 5] = 1.0
    return out


def prepare_sample(sample: Dict[str, np.ndarray], capacity: int,
                   polarity_aware: bool = False,
                   pos_capacity: Optional[int] = None,
                   lut_cell_sort_params: Optional[tuple] = None
                   ) -> Dict[str, np.ndarray]:
    """One sample's share of the collate: its events padded (polarity
    packed) to the capacity and, with `lut_cell_sort_params`, cell-sorted
    with their 'lut_cell_ends'; 'num_pos_events' with polarity_aware.  The
    other entries pass through.  `stack_samples` of prepared samples is
    `collate_fixed_capacity` of the samples."""
    out = {k: v for k, v in sample.items()
           if k not in ("events", "pos_events", "neg_events")}
    if "events" not in sample and "pos_events" not in sample:
        return out
    npos = -1
    if polarity_aware:
        if pos_capacity is None:
            pos_capacity = capacity // 2
        ev = np.concatenate([pad_events(sample["pos_events"], pos_capacity),
                             pad_events(sample["neg_events"],
                                        capacity - pos_capacity)])
        out["num_pos_events"] = npos = pos_capacity
    else:
        ev = pad_events(sample["events"], capacity)
    if lut_cell_sort_params is not None:
        from .host_ops import lut_cell_sort

        image_shape, num_bins, superpixel = lut_cell_sort_params
        ev, out["lut_cell_ends"] = lut_cell_sort(
            ev, image_shape, num_bins, superpixel, num_pos_events=npos)
    out["events"] = ev
    return out


_STACKED = ("lut_cell_ends", "events", "voxel", "forward_flow", "flow_valid",
            "timestamp", "file_index", "ev_repr", "flow", "flow_timestamps",
            "id_mask")


def stack_samples(prepared: List[Dict[str, np.ndarray]],
                  alloc: Optional[Callable] = None) -> Dict[str, np.ndarray]:
    """Stack prepared samples into the batch.  `alloc(shape, dtype)` gives
    the output arrays (pinned host memory for the loader), else np.stack
    allocates them."""
    batch: Dict[str, np.ndarray] = {}
    if "num_pos_events" in prepared[0]:
        batch["num_pos_events"] = prepared[0]["num_pos_events"]
    for key in _STACKED:
        if key not in prepared[0]:
            continue
        arrs = [np.asarray(s[key]) for s in prepared]
        if alloc is None:
            batch[key] = np.stack(arrs)
        else:
            out = alloc((len(arrs),) + arrs[0].shape,
                        np.result_type(*arrs))
            batch[key] = np.stack(arrs, out=out)
    if "name" in prepared[0]:
        batch["name"] = [s["name"] for s in prepared]
    return batch


def collate_fixed_capacity(samples: List[Dict[str, np.ndarray]],
                           capacity: int, polarity_aware: bool = False,
                           pos_capacity: Optional[int] = None,
                           lut_cell_sort_params: Optional[tuple] = None
                           ) -> Dict[str, np.ndarray]:
    """Stack samples into a static-shaped batch of numpy arrays.

    Args:
      samples: dicts with 'events' [n, 5] (or 'pos_events' / 'neg_events'
        when polarity_aware), optional 'voxel' [C, H, W], 'forward_flow'
        [2, H, W], 'flow_valid' [H, W], 'timestamp', 'file_index', 'name',
        and the trajectory samples' 'ev_repr', 'flow', 'flow_timestamps',
        'id_mask' (stacked as they are).
      capacity: per-sample event capacity (both halves together when
        polarity_aware).
      pos_capacity: positive capacity (capacity // 2 when None).
      lut_cell_sort_params: (image_shape, num_bins, superpixel) to sort the
        events by LUT cell and add 'lut_cell_ends' [B, S * cells].

    Returns:
      the batch; 'num_pos_events' is a Python int with polarity_aware.
    """
    return stack_samples([prepare_sample(s, capacity, polarity_aware,
                                         pos_capacity, lut_cell_sort_params)
                          for s in samples])

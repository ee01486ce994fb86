"""Fixed-capacity batching of ragged event streams (JAX: data/collate.py).

Events are padded (or tail-truncated) to a static capacity, with the 6th
'valid' column marking real rows.  Polarity-aware batching packs positives
first at a static positive capacity (capacity // 2 by default).  With
`lut_cell_sort_params` events are sorted by flow-LUT cell within each
polarity segment and the batch carries 'lut_cell_ends'.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def pad_events(events: np.ndarray, capacity: int) -> np.ndarray:
    """[n, 5] (y, x, t, p, bin) -> [capacity, 6] with the valid column;
    events beyond capacity are dropped from the tail."""
    n = min(len(events), capacity)
    out = np.zeros((capacity, 6), dtype=np.float32)
    out[:n, :5] = events[:n, :5]
    out[:n, 5] = 1.0
    return out


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
    batch: Dict[str, np.ndarray] = {}
    if "events" not in samples[0] and "pos_events" not in samples[0]:
        ev = None
    elif polarity_aware:
        if pos_capacity is None:
            pos_capacity = capacity // 2
        neg_capacity = capacity - pos_capacity
        ev = [np.concatenate([pad_events(s["pos_events"], pos_capacity),
                              pad_events(s["neg_events"], neg_capacity)])
              for s in samples]
        batch["num_pos_events"] = pos_capacity
    else:
        ev = [pad_events(s["events"], capacity) for s in samples]
    if ev is not None:
        if lut_cell_sort_params is not None:
            from .host_ops import lut_cell_sort

            image_shape, num_bins, superpixel = lut_cell_sort_params
            npos = batch.get("num_pos_events", -1)
            pairs = [lut_cell_sort(e, image_shape, num_bins, superpixel,
                                   num_pos_events=npos) for e in ev]
            ev = [p[0] for p in pairs]
            batch["lut_cell_ends"] = np.stack([p[1] for p in pairs])
        batch["events"] = np.stack(ev)
    for key in ("voxel", "forward_flow", "flow_valid", "timestamp",
                "file_index", "ev_repr", "flow", "flow_timestamps", "id_mask"):
        if key in samples[0]:
            batch[key] = np.stack([np.asarray(s[key]) for s in samples])
    if "name" in samples[0]:
        batch["name"] = [s["name"] for s in samples]
    return batch

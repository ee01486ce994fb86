"""EVIMO2 dense continuous-time trajectory dataset (JAX: data/evimo2.py).

Host-side NumPy reader, the same as the JAX package's, of the reference
EVIMO2 loader (src/loader/evimo2/datasubset.py + provider.py):
  * requires num_bins_context == 41; context->corr map {6:4, 11:7, 21:13,
    41:25} (datasubset.py:31-44)
  * event window = [flow_t - 0.4 s, flow_t + flow_time] via np.searchsorted
    over the mmap'd event times (:100-109)
  * polarity flipped 1 - p (:154)
  * 66-bin voxel grid at 480x640, bilinear-resized to 384x512 with the GT
    flow xy-rescaled accordingly (:159-189); GT channel 0 is x (x_scale)
  * GT from dataset_multiflow_10steps_vis.h5: multiflow + obj_id_mask +
    NaN -> valid mask (:166-183); timestamps linspace(0,1,1+steps)[1:]
  * optional raw events (y, x, t_norm, p, bin) over the last flow_time ms
    for the CMax loss (:206-228), split into polarity halves for
    polarity-aware batching.  They stay in the 480x640 sensor frame while
    the voxel grid and the loss image are 384x512; `x_scale` / `y_scale`
    are emitted and read by nothing, as in the JAX package.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List

import numpy as np

from .host_ops import (norm_voxel_grid_numpy, resize_bilinear, resize_nearest,
                       voxel_grid_numpy)
from .keys import BatchKeys as K
from .keys import DataSetType

NBINS_CONTEXT2CORR = {6: 4, 11: 7, 21: 13, 41: 25}
NBINS_CONTEXT2DELTATIME_US = {6: 100000, 11: 50000, 21: 25000, 41: 12500}


class Evimo2Datasubset:
    """One EVIMO2 sequence directory (imo/eval/<seq>)."""

    def __init__(self, seq_path: Path, num_bins_context: int = 41,
                 flow_time_ms: int = 300, normalize_voxel_grid: bool = True,
                 provide_raw_events: bool = False,
                 polarity_aware_batching: bool = False,
                 flow_every_n_ms: int = 50):
        seq_path = Path(seq_path)
        if not seq_path.is_dir():
            raise FileNotFoundError(f"EVIMO2 sequence dir missing: {seq_path}")
        if num_bins_context != 41:
            raise ValueError("the reference pins EVIMO2 context bins to 41")
        self.seq_path = seq_path
        self.num_bins_context = num_bins_context
        self.num_bins_correlation = NBINS_CONTEXT2CORR[num_bins_context]
        self.num_bins_total = (self.num_bins_context
                               + self.num_bins_correlation - 1)
        self.flow_duration_ms = flow_time_ms
        self.flow_every_n_ms = flow_every_n_ms
        self.normalize = normalize_voxel_grid
        self.provide_raw_events = provide_raw_events
        self.polarity_aware_batching = polarity_aware_batching

        self.original_hw = (480, 640)
        self.resize_hw = (384, 512)
        self.t_bins = np.linspace(0, 1, num_bins_context + 1)

        import h5py

        self.flow_path = seq_path / "dataset_multiflow_10steps_vis.h5"
        with h5py.File(self.flow_path, "r") as h5f:
            self.flow_time = np.asarray(h5f["time"])

        self.xy_path = seq_path / "dataset_events_xy.npy"
        self.p_path = seq_path / "dataset_events_p.npy"
        self.t_path = seq_path / "dataset_events_t.npy"

        evt = np.load(self.t_path)
        prev_time = self.flow_time - 0.4
        next_time = self.flow_time + self.flow_duration_ms / 1000
        self.prev2evt = np.searchsorted(evt, prev_time, side="left")
        self.next2evt = np.searchsorted(evt, next_time, side="left")

        self.start_index = 0
        for tid in range(len(self.flow_time)):
            if (self.flow_time[tid] - evt[0]) > 0.4:
                self.start_index = tid
                break
        self.length = len(self.flow_time) - self.start_index

    def __len__(self) -> int:
        return self.length

    def bin_idx_for_reference(self) -> int:
        return self.num_bins_correlation - 1

    def __getitem__(self, index: int) -> Dict:
        import h5py

        index = index + self.start_index
        xy = np.load(self.xy_path, mmap_mode="r")
        p = np.load(self.p_path, mmap_mode="r")
        t = np.load(self.t_path, mmap_mode="r")

        lo, hi = self.prev2evt[index], self.next2evt[index]
        xs = np.asarray(xy[lo:hi, 0]).astype("int32")
        ys = np.asarray(xy[lo:hi, 1]).astype("int32")
        ts = (np.asarray(t[lo:hi]) * 1e6).astype("int64")
        ps = 1 - np.asarray(p[lo:hi]).astype("int32")  # polarity flip (:154)

        h, w = self.original_hw
        rh, rw = self.resize_hw
        voxel = voxel_grid_numpy(xs, ys, ps, ts, self.num_bins_total, h, w)
        if self.normalize:
            voxel = norm_voxel_grid_numpy(voxel)

        num_flow_steps = int(self.flow_duration_ms // self.flow_every_n_ms)
        with h5py.File(self.flow_path, "r") as h5f:
            gt_flow = np.asarray(h5f["multiflow"][index])[:num_flow_steps]
            id_mask = np.asarray(h5f["obj_id_mask"][index])
        gt_flow_ts = np.linspace(0, 1, 1 + num_flow_steps)[1:]

        flow_valid = (~np.isnan(gt_flow[:, 0])) & (~np.isnan(gt_flow[:, 1]))
        gt_flow = np.nan_to_num(gt_flow, nan=0.0).astype(np.float32)

        y_scale = rh / h
        x_scale = rw / w
        gt_flow = resize_bilinear(gt_flow, rh, rw)
        gt_flow[:, 0] *= x_scale   # channel 0 = x (:186-188)
        gt_flow[:, 1] *= y_scale
        flow_valid = resize_nearest(flow_valid.astype(np.float32), rh, rw) > 0
        id_mask = resize_nearest(id_mask.astype(np.float32), rh, rw)
        voxel = resize_bilinear(voxel, rh, rw)

        out = {
            K.BIN_META.value: {
                "bin_idx_for_reference": self.bin_idx_for_reference(),
                "nbins_context": self.num_bins_context,
                "nbins_correlation": self.num_bins_correlation,
                "nbins_total": self.num_bins_total,
            },
            K.FLOW.value: gt_flow,
            K.FLOW_TIMESTAMPS.value: gt_flow_ts.astype(np.float32),
            K.DATASET_TYPE.value: DataSetType.EVIMO2,
            K.EV_REPR.value: voxel,
            K.FLOW_VALID.value: flow_valid,
            K.ID_MASK.value: id_mask,
        }

        if self.provide_raw_events:
            # Events over the final flow_duration window, (y, x, t_norm, p, bin)
            # rows (:206-228).
            all_events = np.stack(
                [ys, xs, ts, ps], axis=1).astype(np.float64)
            ts_start = ts[-1] - self.flow_duration_ms * 1e3
            ts_end = ts[-1]
            ev = all_events[all_events[:, 2] > ts_start].astype(np.float32)
            ev[:, 2] = (ev[:, 2] - ts_start) / max(ts_end - ts_start, 1)
            bins = np.searchsorted(self.t_bins, ev[:, 2]) - 1
            bins[bins == -1] = 0
            ev = np.concatenate([ev, bins[:, None].astype(np.float32)], axis=1)
            if self.polarity_aware_batching:
                out[K.POS_EVENTS.value] = ev[ev[:, 3] == 1]
                out[K.NEG_EVENTS.value] = ev[ev[:, 3] == 0]
            else:
                out[K.EVENTS.value] = ev
            out[K.X_SCALE.value] = x_scale
            out[K.Y_SCALE.value] = y_scale
        return out


class Evimo2Provider:
    """The sequence dirs of one split, imo/eval (validation, provider.py:
    12-68) or imo/train (self-supervised training: JAX cli/main.py
    cmd_traj_train reads every imo/train/<seq> with raw events), indexed
    as one dataset."""

    def __init__(self, dataset_path: str, nbins_context: int = 41,
                 flow_time_ms: int = 300, normalize_voxel_grid: bool = True,
                 flow_every_n_ms: int = 50, provide_raw_events: bool = False,
                 polarity_aware_batching: bool = False, split: str = "eval"):
        dataset_path = Path(dataset_path)
        val_path = dataset_path / "imo" / split
        if not val_path.is_dir() or not os.listdir(val_path):
            raise FileNotFoundError(
                f"EVIMO2 {split} split missing or empty: {val_path}")
        self.val_subsets: List[Evimo2Datasubset] = [
            Evimo2Datasubset(val_path / d, nbins_context, flow_time_ms,
                             normalize_voxel_grid, provide_raw_events,
                             polarity_aware_batching=polarity_aware_batching,
                             flow_every_n_ms=flow_every_n_ms)
            for d in sorted(os.listdir(val_path))
        ]
        self._cum = np.cumsum([0] + [len(s) for s in self.val_subsets])
        self.nbins_context = nbins_context
        self.nbins_correlation = NBINS_CONTEXT2CORR[nbins_context]

    def __len__(self) -> int:
        return int(self._cum[-1])

    def __getitem__(self, idx: int) -> Dict:
        si = int(np.searchsorted(self._cum, idx, side="right")) - 1
        return self.val_subsets[si][idx - int(self._cum[si])]

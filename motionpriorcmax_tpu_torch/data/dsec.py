"""DSEC optical-flow dataset: event slicing and sample assembly
(JAX: data/dsec.py; the port's own copy, h5py imported when a sequence is
opened).

  * the 24 train / 2 val sequences of the reference split
  * 100 ms windows from the image timestamps [::2][1:-1] (train),
    flow/forward_timestamps.txt (val) or a benchmark timestamp CSV (test)
  * events.h5 slicing through ms_to_idx plus an exact searchsorted refine;
    a sequence can also read an already opened events file or a mapping of
    numpy arrays under the same keys (no h5py then)
  * per-event rectification map lookup (native C++ or NumPy)
  * events packed as (y, x, t_norm, p, bin) float32 rows, optionally split
    by polarity, optionally voxelized on the host
  * GT flow decoded from the 16-bit PNGs (train and val)
"""

from __future__ import annotations

import csv
import math
import os
import weakref
from pathlib import Path
from typing import Dict, List, Mapping, Optional

import numpy as np

from ..utils.flow_io import load_flow_png

TRAIN_SEQS = [
    "zurich_city_04_d", "zurich_city_02_a", "interlaken_00_f", "zurich_city_11_a",
    "zurich_city_04_b", "zurich_city_02_d", "interlaken_00_d", "zurich_city_04_c",
    "zurich_city_07_a", "zurich_city_04_f", "zurich_city_06_a", "zurich_city_11_b",
    "interlaken_00_c", "zurich_city_02_b", "interlaken_00_e", "zurich_city_04_a",
    "zurich_city_05_a", "zurich_city_02_e", "zurich_city_03_a", "interlaken_00_g",
    "zurich_city_08_a", "zurich_city_04_e", "thun_00_a", "zurich_city_02_c",
]
VAL_SEQS = ["zurich_city_05_b", "zurich_city_11_c"]

HEIGHT, WIDTH = 480, 640
DELTA_T_US = 100_000


class EventSlicer:
    """Events of an events.h5 with t0 <= t < t1 (GPS time, microseconds).

    `h5f` is the opened file or any mapping with its keys: 'events/p',
    'events/x', 'events/y', 'events/t', 'ms_to_idx' and 't_offset'."""

    def __init__(self, h5f):
        self.events = {k: h5f[f"events/{k}"] for k in ("p", "x", "y", "t")}
        self.ms_to_idx = np.asarray(h5f["ms_to_idx"], dtype="int64")
        self.t_offset = int(h5f["t_offset"][()])
        self.t_final = int(self.events["t"][-1]) + self.t_offset

    def get_events(self, t_start_us: int, t_end_us: int
                   ) -> Optional[Dict[str, np.ndarray]]:
        if t_start_us >= t_end_us:
            raise ValueError(f"empty window [{t_start_us}, {t_end_us})")
        t_start_us -= self.t_offset
        t_end_us -= self.t_offset
        win_start_ms = math.floor(t_start_us / 1000)
        win_end_ms = math.ceil(t_end_us / 1000)
        if win_start_ms < 0 or win_end_ms >= self.ms_to_idx.size:
            return None
        idx0 = int(self.ms_to_idx[win_start_ms])
        idx1 = int(self.ms_to_idx[win_end_ms])
        t_arr = np.asarray(self.events["t"][idx0:idx1], dtype="int64")
        off0 = int(np.searchsorted(t_arr, t_start_us, side="left"))
        off1 = int(np.searchsorted(t_arr, t_end_us, side="left"))
        out = {"t": t_arr[off0:off1] + self.t_offset}
        for k in ("p", "x", "y"):
            out[k] = np.asarray(self.events[k][idx0 + off0:idx0 + off1])
        return out


class DsecSequence:
    """One DSEC sequence for phase 'train', 'val' or 'test'.

    'test' reads its windows from `timestamp_path`, a benchmark CSV
    (from_timestamp_us, to_timestamp_us, file_index), and has no GT flow.
    With `event_file` (an opened events.h5, or a mapping of numpy arrays
    under its keys, see `EventSlicer`) and `rectify_map` ([480, 640, 2]
    f32) the sequence reads those instead of the files under
    events/left/; `seq_path` then only names it for phase 'test'.
    """

    def __init__(self, seq_path: Path, phase: str = "train",
                 num_bins: int = 15, timestamp_path: Optional[str] = None,
                 polarity_aware_batching: bool = False,
                 host_voxelize: bool = False,
                 voxel_norm_type: Optional[str] = "mean_std",
                 voxel_quantile: float = 0.0,
                 event_file: Optional[Mapping] = None,
                 rectify_map: Optional[np.ndarray] = None):
        seq_path = Path(seq_path)
        if (event_file is None) != (rectify_map is None):
            raise ValueError("event_file and rectify_map go together")
        if event_file is None and not seq_path.is_dir():
            raise FileNotFoundError(seq_path)
        self.name = seq_path.name
        self.num_bins = num_bins
        self.polarity_aware_batching = polarity_aware_batching
        self.host_voxelize = host_voxelize
        self.voxel_norm_type = voxel_norm_type
        self.voxel_quantile = voxel_quantile
        self.height, self.width = HEIGHT, WIDTH
        self.t_bins = np.linspace(0, 1, num_bins + 1)

        if phase not in ("train", "val", "test"):
            raise ValueError(f"unknown phase {phase!r} (train, val, test)")
        if phase == "test" and timestamp_path is None:
            raise ValueError("phase 'test' needs the timestamp CSV "
                             "(timestamp_path)")
        if event_file is None:
            import h5py

            ev_dir = seq_path / "events/left"
            event_file = h5py.File(ev_dir / "events.h5", "r")
            self._finalizer = weakref.finalize(self, event_file.close)
            with h5py.File(ev_dir / "rectify_map.h5", "r") as rf:
                rectify_map = rf["rectify_map"][()]
        self.event_slicer = EventSlicer(event_file)
        self.rectify_ev_map = rectify_map
        self._rectify_f32 = None
        self.paths_to_forward_flow: Optional[List[Path]] = None
        if phase == "train":
            self._load_train(seq_path)
        elif phase == "val":
            self._load_val(seq_path)
        else:
            self._load_test(timestamp_path)

    def _load_train(self, seq_path: Path):
        ts_img = np.loadtxt(seq_path / "images/timestamps.txt", dtype="int64")
        idx = np.arange(len(ts_img))
        start = ts_img[::2][1:-1]
        self.timestamps_flow = np.stack((start, start + DELTA_T_US), axis=1)
        self.indices = idx[::2][1:-1]
        keep = self.timestamps_flow[:, 1] < self.event_slicer.t_final
        self.timestamps_flow = self.timestamps_flow[keep]
        self.indices = self.indices[keep]
        self.paths_to_forward_flow = [
            seq_path / "flow/forward" / f"{str(i).zfill(6)}.png"
            for i in self.indices]

    def _load_val(self, seq_path: Path):
        self.timestamps_flow = np.loadtxt(
            seq_path / "flow/forward_timestamps.txt", delimiter=",",
            skiprows=1, dtype="int64")
        keep = self.timestamps_flow[:, 0] > self.event_slicer.t_offset
        self.timestamps_flow = self.timestamps_flow[keep]
        files = [f for f, k in zip(sorted(os.listdir(seq_path / "flow/forward")),
                                   keep) if k]
        self.paths_to_forward_flow = [seq_path / "flow/forward" / f
                                      for f in files]
        self.indices = [int(f.split(".")[0]) for f in files]

    def _load_test(self, timestamp_path: str):
        """Windows and file indices of a benchmark CSV (its rows have a
        space after each comma)."""
        with open(timestamp_path) as fh:
            rows = [(int(r["from_timestamp_us"]), int(r["to_timestamp_us"]),
                     int(r["file_index"])) for r in csv.DictReader(fh)]
        table = np.asarray(rows, dtype="int64").reshape(-1, 3)
        self.timestamps_flow = table[:, :2]
        self.indices = table[:, 2]

    def __len__(self) -> int:
        return len(self.timestamps_flow)

    def _pack_events(self, ev: Dict[str, np.ndarray]) -> np.ndarray:
        """Rectify, normalize t to [0, 1], bin, drop out-of-image events ->
        [M, 5] (y, x, t, p, bin) f32: the native pack when it is built (as
        the JAX reader does), else its NumPy twin."""
        from .. import native

        if native.available():
            if self._rectify_f32 is None:
                self._rectify_f32 = np.ascontiguousarray(
                    self.rectify_ev_map, np.float32)
            return native.pack_dsec_events(
                ev["x"], ev["y"], ev["t"], ev["p"], self._rectify_f32,
                self.height, self.width, self.num_bins)
        xy_rect = self.rectify_ev_map[ev["y"], ev["x"]]
        x_rect, y_rect = xy_rect[..., 0], xy_rect[..., 1]
        t = (ev["t"] - ev["t"].min()) / max(ev["t"].max() - ev["t"].min(), 1)
        bin_indices = np.clip(np.searchsorted(self.t_bins, t) - 1, 0, None)
        events = np.column_stack((y_rect, x_rect, t, ev["p"], bin_indices))
        mask = ((0 <= events[:, 0]) & (events[:, 0] < self.height)
                & (0 <= events[:, 1]) & (events[:, 1] < self.width))
        return events[mask].astype("float32")

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        t_start, t_end = self.timestamps_flow[index]
        file_index = int(self.indices[index])
        out: Dict[str, np.ndarray] = {
            "name": f"{self.name}_{str(file_index).zfill(6)}",
            "timestamp": np.asarray([t_start, t_end], dtype="int64"),
            "file_index": np.asarray(file_index, dtype="int64"),
        }
        events = self._pack_events(
            self.event_slicer.get_events(int(t_start), int(t_end)))
        if self.host_voxelize:
            from .host_ops import voxelize_normalized_host

            out["voxel"] = voxelize_normalized_host(
                events, self.num_bins, self.height, self.width,
                self.voxel_norm_type, self.voxel_quantile)
        if self.polarity_aware_batching:
            out["pos_events"] = events[events[:, 3] == 1]
            out["neg_events"] = events[events[:, 3] == 0]
        else:
            out["events"] = events
        if self.paths_to_forward_flow is not None:
            flow_path = Path(self.paths_to_forward_flow[index])
            if flow_path.exists():
                out["forward_flow"], out["flow_valid"] = load_flow_png(
                    flow_path)
        return out


class DsecDatasetProvider:
    """Concatenation of the split's sequences under `dataset_path`."""

    def __init__(self, dataset_path: str, split: str = "train",
                 num_bins: int = 15, polarity_aware_batching: bool = False,
                 host_voxelize: bool = False,
                 voxel_norm_type: Optional[str] = "mean_std",
                 voxel_quantile: float = 0.0):
        dataset_path = Path(dataset_path)
        if not dataset_path.is_dir():
            raise FileNotFoundError(dataset_path)
        names = {"train": TRAIN_SEQS, "val": VAL_SEQS}[split]
        self.sequences: List[DsecSequence] = [
            DsecSequence(child, split, num_bins,
                         polarity_aware_batching=polarity_aware_batching,
                         host_voxelize=host_voxelize,
                         voxel_norm_type=voxel_norm_type,
                         voxel_quantile=voxel_quantile)
            for child in sorted(dataset_path.iterdir()) if child.name in names]
        self._cum = np.cumsum([0] + [len(s) for s in self.sequences])

    def __len__(self) -> int:
        return int(self._cum[-1])

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        seq_i = int(np.searchsorted(self._cum, idx, side="right")) - 1
        return self.sequences[seq_i][idx - int(self._cum[seq_i])]

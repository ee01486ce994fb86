"""MultiFlow 2D dataset: trajectory samples with boundary images
(JAX: data/multiflow.py; the port's own copy).

  * 384x512; reference image at 0.4 s, target at 0.9 s
  * context window = [img_ref - (corr-1)*delta_t, ref + prediction_time];
    the extended voxel grid pads +/-1 bin of time
  * GT flow h5 every n ms up to the prediction horizon
  * voxel-grid disk cache `voxel_grid_v{ver}_{bins}_bins.h5` (gzip)
  * cap_num_events filter with NUM_EVENTS_MAX
  * raw (y, x, t_norm, p, bin) context events for the CMax loss, split into
    polarity halves for polarity-aware batching
  * augmentation as an optional callable (data/augment.py)

h5py is imported when a file is read.  The boundary images are read with
the port's PNG reader (utils/png16.py: 8- or 16-bit RGB), where the JAX
package uses imageio.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from ..utils.png16 import read_png_rgb
from .host_ops import norm_voxel_grid_numpy
from .keys import BatchKeys as K
from .keys import DataSetType

NUM_EVENTS_MAX = 23542180
NBINS_CONTEXT2CORR = {6: 4, 11: 7, 21: 13, 41: 25}
NBINS_CONTEXT2DELTATIME_US = {6: 100000, 11: 50000, 21: 25000, 41: 12500}


class MultiflowSample:
    """One seq* directory (events/events.h5, flow/*.h5, images/*.png)."""

    def __init__(self, sample_path: Path, height: int = 384, width: int = 512,
                 num_bins_context: int = 41, load_voxel_grid: bool = True,
                 extended_voxel_grid: bool = True,
                 prediction_time_ms: int = 500):
        sample_path = Path(sample_path)
        if not sample_path.is_dir():
            raise FileNotFoundError(f"MultiFlow sample dir missing: {sample_path}")
        if num_bins_context not in NBINS_CONTEXT2CORR:
            raise ValueError(f"num_bins_context must be one of "
                             f"{sorted(NBINS_CONTEXT2CORR)}, got {num_bins_context}")
        self.height, self.width = height, width
        self.num_bins_context = num_bins_context
        self.num_bins_correlation = NBINS_CONTEXT2CORR[num_bins_context]
        self.num_bins_total = self.num_bins_context + self.num_bins_correlation - 1
        self.t_bins = np.linspace(0, 1, num_bins_context + 1)

        ref_time_us, target_time_us = 400_000, 900_000
        img_dir = sample_path / "images"
        self.img_filepaths = [img_dir / f"{t:07d}.png"
                              for t in (ref_time_us, target_time_us)]
        for p in self.img_filepaths:
            if not p.exists():
                raise FileNotFoundError(p)
        self.img_ts = [ref_time_us, target_time_us]

        delta = NBINS_CONTEXT2DELTATIME_US[num_bins_context]
        self.bin_0_time = self.img_ts[0] - (self.num_bins_correlation - 1) * delta
        if self.bin_0_time < 0:
            raise ValueError("the context window starts before the sequence")
        self.flow_ref_ts_us = ref_time_us

        flow_dir = sample_path / "flow"
        self.flow_filepaths = sorted(flow_dir.glob("*.h5"))
        self.flow_ts_us = [int(p.stem) for p in self.flow_filepaths]

        self.event_filepath = sample_path / "events" / "events.h5"
        if not self.event_filepath.exists():
            raise FileNotFoundError(self.event_filepath)

        self.version = 1 if extended_voxel_grid else 0
        self.voxel_grid_file = (sample_path / "events" /
                                f"voxel_grid_v{self.version}_{self.num_bins_total}_bins.h5")
        self.load_voxel_grid_from_disk = load_voxel_grid
        self.prediction_time_us = int(prediction_time_ms * 1e3)

    def get_flow_gt(self, flow_every_n_ms: int) -> Dict[str, list]:
        import h5py

        if flow_every_n_ms <= 0 or flow_every_n_ms % 10:
            raise ValueError("flow_every_n_ms must be a positive multiple of 10")
        delta_us = flow_every_n_ms * 1000
        out = {"flow": [], "timestamps": []}
        for ts, path in zip(self.flow_ts_us, self.flow_filepaths):
            if (ts - self.flow_ref_ts_us) % delta_us != 0:
                continue
            if ts > self.flow_ref_ts_us + self.prediction_time_us:
                break
            out["timestamps"].append(ts)
            with h5py.File(str(path), "r") as h5f:
                flow = np.moveaxis(np.asarray(h5f["flow"]), -1, 0)  # [2, H, W]
            out["flow"].append(flow.astype(np.float32))
        return out

    def get_images(self) -> Dict[str, list]:
        images = []
        for p in self.img_filepaths:
            img = read_png_rgb(p)
            if img.dtype == np.uint16:
                # imageio (PIL) narrows 16-bit RGB to its high byte: the
                # images stay in [0, 255], as the augmentors expect.
                img = img >> 8
            images.append(np.moveaxis(img, -1, 0).astype(np.float32))
        return {"images": images, "timestamps": list(self.img_ts)}

    def _get_events(self, t_start: int, t_end: int) -> Dict[str, np.ndarray]:
        import h5py

        with h5py.File(str(self.event_filepath), "r") as h5f:
            time = np.asarray(h5f["t"])
            i0 = np.searchsorted(time, t_start, side="left")
            i1 = np.searchsorted(time, t_end, side="right")
            return {
                "x": np.asarray(h5f["x"][i0:i1]),
                "y": np.asarray(h5f["y"][i0:i1]),
                "p": np.asarray(h5f["p"][i0:i1]),
                "t": time[i0:i1],
            }

    def _construct_voxel_grid(self, ts_from: int, ts_to: int) -> np.ndarray:
        if self.version == 1:
            # Extended window: +/- one bin width of events beyond the centres,
            # normalized so that bin 0 is centred at ts_from.
            dt = (ts_to - ts_from) / (self.num_bins_total - 1)
            t_start = math.floor(ts_from - dt)
            t_end = math.ceil(ts_to + dt)
            ev = self._get_events(max(t_start, 0), min(t_end, 1_000_000))
            t_norm = ((ev["t"].astype(np.float64) - ts_from)
                      / (ts_to - ts_from) * (self.num_bins_total - 1))
        else:
            ev = self._get_events(ts_from, ts_to)
            if len(ev["t"]) == 0:
                t_norm = ev["t"].astype(np.float64)
            else:
                t0, t1 = ev["t"][0], ev["t"][-1]
                t_norm = ((ev["t"].astype(np.float64) - t0)
                          / max(t1 - t0, 1) * (self.num_bins_total - 1))
        return self._vote(ev, t_norm)

    def _vote(self, ev, t_norm) -> np.ndarray:
        # Integer-coordinate two-tap time vote.
        grid = np.zeros(self.num_bins_total * self.height * self.width,
                        dtype=np.float64)
        value = 2.0 * ev["p"].astype(np.float64) - 1.0
        x = ev["x"].astype(np.int64)
        y = ev["y"].astype(np.int64)
        tf = np.floor(t_norm)
        for tlim in (tf, tf + 1):
            mask = (tlim >= 0) & (tlim < self.num_bins_total)
            w = value * (1.0 - np.abs(tlim - t_norm))
            idx = (tlim.astype(np.int64) * self.height + y) * self.width + x
            np.add.at(grid, idx[mask], w[mask])
        return grid.reshape(self.num_bins_total, self.height,
                            self.width).astype(np.float32)

    def get_voxel_grid(self) -> np.ndarray:
        import h5py

        ts_from = self.bin_0_time
        ts_to = self.flow_ref_ts_us + self.prediction_time_us
        if self.load_voxel_grid_from_disk:
            if self.voxel_grid_file.exists():
                try:
                    with h5py.File(str(self.voxel_grid_file), "r") as h5f:
                        return np.asarray(h5f["voxel_grid"]).squeeze()
                except OSError:
                    pass
            grid = self._construct_voxel_grid(ts_from, ts_to)
            with h5py.File(str(self.voxel_grid_file), "w") as h5f:
                h5f.create_dataset("voxel_grid", data=grid, compression="gzip",
                                   compression_opts=1)
            return grid
        return self._construct_voxel_grid(ts_from, ts_to)

    def get_events_context(self) -> np.ndarray:
        """(y, x, t_norm, p, bin) rows over [ref, ref + prediction_time]."""
        ev = self._get_events(self.flow_ref_ts_us,
                              self.flow_ref_ts_us + self.prediction_time_us)
        t = ev["t"].astype(np.float64)
        t = (t - t.min()) / max(t.max() - t.min(), 1)
        bins = np.searchsorted(self.t_bins, t) - 1
        bins[bins == -1] = 0
        return np.column_stack(
            (ev["y"], ev["x"], t, ev["p"], bins)).astype(np.float32)

    def bin_idx_for_reference(self) -> int:
        return self.num_bins_correlation - 1


class MultiflowDatasubset:
    """train/ or test/ directory of seq* samples."""

    def __init__(self, split_path: Path, num_bins_context: int = 41,
                 flow_every_n_ms: int = 100, load_voxel_grid: bool = True,
                 extended_voxel_grid: bool = True,
                 normalize_voxel_grid: bool = False,
                 provide_raw_events: bool = False,
                 polarity_aware_batching: bool = False,
                 cap_num_events: bool = False, prediction_time_ms: int = 500,
                 augmentor: Optional[Callable] = None):
        import h5py

        split_path = Path(split_path)
        if not split_path.is_dir():
            raise FileNotFoundError(f"MultiFlow split dir missing: {split_path}")
        if not 100 <= prediction_time_ms <= 500:
            raise ValueError("prediction_time_ms must be in [100, 500]")
        self.provide_raw_events = provide_raw_events
        self.polarity_aware_batching = polarity_aware_batching
        self.delta_ts_flow_ms = flow_every_n_ms
        self.normalize = normalize_voxel_grid
        self.augmentor = augmentor

        self.sample_list: List[MultiflowSample] = []
        for sample_path in sorted(split_path.iterdir()):
            if not sample_path.is_dir():
                continue
            with h5py.File(sample_path / "events" / "events.h5", "r") as ev:
                if len(ev["t"]) < NUM_EVENTS_MAX or not cap_num_events:
                    self.sample_list.append(MultiflowSample(
                        sample_path, num_bins_context=num_bins_context,
                        load_voxel_grid=load_voxel_grid,
                        extended_voxel_grid=extended_voxel_grid,
                        prediction_time_ms=prediction_time_ms))

    def __len__(self) -> int:
        return len(self.sample_list)

    def __getitem__(self, index: int) -> Dict:
        sample = self.sample_list[index]
        voxel = sample.get_voxel_grid()
        if self.normalize:
            voxel = norm_voxel_grid_numpy(voxel)

        gt = sample.get_flow_gt(self.delta_ts_flow_ms)
        imgs = sample.get_images()

        ts_start = imgs["timestamps"][0]
        ts_end = gt["timestamps"][-1]
        gt_flow_ts = [(t - ts_start) / (ts_end - ts_start)
                      for t in gt["timestamps"]]

        events = (sample.get_events_context()
                  if self.provide_raw_events else None)

        if self.augmentor is not None:
            voxel, gt_flow, imgs_list, events = self.augmentor(
                voxel, gt["flow"], imgs["images"], events)
        else:
            gt_flow, imgs_list = gt["flow"], imgs["images"]

        out = {
            K.BIN_META.value: {
                "bin_idx_for_reference": sample.bin_idx_for_reference(),
                "nbins_context": sample.num_bins_context,
                "nbins_correlation": sample.num_bins_correlation,
                "nbins_total": sample.num_bins_total,
            },
            K.FLOW.value: np.stack(gt_flow, axis=0),
            K.FLOW_TIMESTAMPS.value: np.asarray(gt_flow_ts, np.float32),
            K.IMG.value: imgs_list,
            K.DATASET_TYPE.value: DataSetType.MULTIFLOW2D,
            K.EV_REPR.value: voxel,
        }
        if events is not None:
            if self.polarity_aware_batching:
                out[K.POS_EVENTS.value] = events[events[:, 3] == 1]
                out[K.NEG_EVENTS.value] = events[events[:, 3] == 0]
            else:
                out[K.EVENTS.value] = events
        return out

"""DSEC-benchmark flow PNGs and the magnitude cap (JAX: utils/flow_io.py;
the port's own copy).

Encoding: 16-bit RGB PNG, channel 0 = x * 128 + 2^15, channel 1 =
y * 128 + 2^15, channel 2 = the valid flag.  Flow arrays are [2, H, W] in
(y, x) order, numpy on the host.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .png16 import read_png_rgb, write_png16_rgb


def scale_optical_flow(flow: np.ndarray, max_flow_magnitude: float
                       ) -> np.ndarray:
    """Scale each pixel's flow [2, H, W] down to at most
    `max_flow_magnitude` px."""
    u, v = flow[0], flow[1]
    mag = np.sqrt(u * u + v * v)
    scale = np.where(mag > max_flow_magnitude,
                     max_flow_magnitude / np.maximum(mag, 1e-12), 1.0)
    return np.stack([u * scale, v * scale], axis=0)


def save_flow_png(file_path: Path, flow: np.ndarray,
                  valid: Optional[np.ndarray] = None) -> None:
    """Write flow [2, H, W] (y, x) as a DSEC-benchmark 16-bit PNG; channel 2
    holds `valid` [H, W] when given (benchmark submissions leave it 0)."""
    h, w = flow.shape[1], flow.shape[2]
    flow_16bit = np.zeros((h, w, 3), dtype=np.uint16)
    flow_16bit[..., 1] = (flow[0] * 128 + 2 ** 15).astype(np.uint16)  # y
    flow_16bit[..., 0] = (flow[1] * 128 + 2 ** 15).astype(np.uint16)  # x
    if valid is not None:
        flow_16bit[..., 2] = valid.astype(np.uint16)
    write_png16_rgb(Path(file_path), flow_16bit)


def load_flow_png(file_path: Path) -> Tuple[np.ndarray, np.ndarray]:
    """DSEC 16-bit flow PNG -> ([2, H, W] f32 (y, x) flow, [H, W] valid)."""
    raw = read_png_rgb(Path(file_path)).astype(np.float32)
    flow = np.zeros((2, raw.shape[0], raw.shape[1]), np.float32)
    flow[0] = (raw[..., 1] - 2 ** 15) / 128.0
    flow[1] = (raw[..., 0] - 2 ** 15) / 128.0
    return flow, raw[..., 2].astype(bool)

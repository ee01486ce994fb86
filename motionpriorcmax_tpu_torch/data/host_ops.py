"""Host-side NumPy voxelization and resizing (JAX: data/host_ops.py:16-93).

  * trilinear voxel vote  == the reference's torch voxel grid
  * bilinear resize       == F.interpolate(mode='bilinear', align_corners=False)
  * nearest resize        == F.interpolate(mode='nearest')
"""

from __future__ import annotations

import numpy as np


def voxel_grid_numpy(x: np.ndarray, y: np.ndarray, pol: np.ndarray,
                     time: np.ndarray, num_bins: int, height: int, width: int
                     ) -> np.ndarray:
    """Trilinear (x, y, t) vote; an integer-coordinate fast path when x/y are
    ints, the full 8-corner path otherwise.

    time is normalized internally: t_norm = (t - t0)/(t1 - t0) * (nbins - 1).
    """
    grid = np.zeros(num_bins * height * width, dtype=np.float64)
    if len(time) == 0:
        return grid.reshape(num_bins, height, width).astype(np.float32)
    t0c, t1c = time[0], time[-1]
    denom = max(int(t1c) - int(t0c), 1)
    t_norm = (time.astype(np.float64) - t0c) / denom * (num_bins - 1)
    value = 2.0 * pol.astype(np.float64) - 1.0

    tf = np.floor(t_norm)
    if np.issubdtype(x.dtype, np.integer):
        for tlim in (tf, tf + 1):
            mask = (tlim >= 0) & (tlim < num_bins)
            w = value * (1.0 - np.abs(tlim - t_norm))
            idx = (tlim.astype(np.int64) * height + y.astype(np.int64)) * width \
                + x.astype(np.int64)
            np.add.at(grid, idx[mask], w[mask])
    else:
        xf = np.floor(x)
        yf = np.floor(y)
        for xlim in (xf, xf + 1):
            for ylim in (yf, yf + 1):
                for tlim in (tf, tf + 1):
                    mask = ((xlim >= 0) & (xlim < width) & (ylim >= 0)
                            & (ylim < height) & (tlim >= 0) & (tlim < num_bins))
                    w = (value * (1 - np.abs(xlim - x)) * (1 - np.abs(ylim - y))
                         * (1 - np.abs(tlim - t_norm)))
                    idx = (tlim.astype(np.int64) * height
                           + ylim.astype(np.int64)) * width + xlim.astype(np.int64)
                    np.add.at(grid, idx[mask], w[mask])
    return grid.reshape(num_bins, height, width).astype(np.float32)


def norm_voxel_grid_numpy(grid: np.ndarray) -> np.ndarray:
    """Mean/std normalization over the nonzero entries."""
    mask = grid != 0
    if mask.any():
        vals = grid[mask]
        mean, std = vals.mean(), vals.std(ddof=1)
        grid = grid.copy()
        grid[mask] = (vals - mean) / std if std > 0 else vals - mean
    return grid


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """[..., H, W] bilinear resize, half-pixel centres (align_corners=False)."""
    h, w = img.shape[-2:]
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys), 0, h - 1).astype(int)
    x0 = np.clip(np.floor(xs), 0, w - 1).astype(int)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    tl = img[..., y0[:, None], x0[None, :]]
    tr = img[..., y0[:, None], x1[None, :]]
    bl = img[..., y1[:, None], x0[None, :]]
    br = img[..., y1[:, None], x1[None, :]]
    top = tl * (1 - fx) + tr * fx
    bot = bl * (1 - fx) + br * fx
    return (top * (1 - fy) + bot * fy).astype(img.dtype)


def resize_nearest(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """[..., H, W] nearest resize (source index = floor(dst * in / out))."""
    h, w = img.shape[-2:]
    ys = np.minimum((np.arange(out_h) * h // out_h), h - 1)
    xs = np.minimum((np.arange(out_w) * w // out_w), w - 1)
    return img[..., ys[:, None], xs[None, :]]

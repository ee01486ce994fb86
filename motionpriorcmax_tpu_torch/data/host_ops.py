"""Host-side NumPy voxelization, resizing and the flow-LUT cell sort
(JAX: data/host_ops.py).

  * trilinear voxel vote  == the reference's torch voxel grid
  * bilinear resize       == F.interpolate(mode='bilinear', align_corners=False)
  * nearest resize        == F.interpolate(mode='nearest')
  * lut_cell_sort         events sorted by flow-LUT cell + run boundaries
  * voxelize_normalized_host  the DSEC loader's voxel grid (normalized t)

The cell sort and the voxel vote run the port's native C++ (`native/`,
built on first use) where the JAX package runs its own, and the NumPy twins
here otherwise (no compiler, or inside `native.numpy_only()`): the sort is
the same either way; the native vote sums in f32, its twin in f64.
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


def lut_cell_keys(events: np.ndarray, image_shape, num_bins: int,
                  superpixel: int) -> tuple:
    """Flat flow-LUT cell id of each [m, 6] event row, y-major
    ((y // s) * num_bins + bin) * Wq + x // s, the device indexing of
    losses/focus.py::warp_events; returns (keys int64 [m], num_cells)."""
    h, w = image_shape
    hq, wq = -(-h // superpixel), -(-w // superpixel)
    s = np.float32(superpixel)
    it = np.clip(events[:, 4].astype(np.int64), 0, num_bins - 1)
    iy = np.clip(np.floor(events[:, 0].astype(np.float32) / s).astype(np.int64),
                 0, hq - 1)
    ix = np.clip(np.floor(events[:, 1].astype(np.float32) / s).astype(np.int64),
                 0, wq - 1)
    return (iy * num_bins + it) * wq + ix, num_bins * hq * wq


def lut_cell_sort(events: np.ndarray, image_shape, num_bins: int,
                  superpixel: int, num_pos_events: int = -1) -> tuple:
    """Sort padded [m, 6] events by flat LUT cell id (stable) within each
    segment, and emit the runs' right boundaries.

    With polarity-aware batching (positives packed first at a static
    capacity, num_pos_events >= 0) each half is sorted on its own and the
    boundaries of both halves are concatenated: cell_ends [S * num_cells]
    int32, globally ascending, entry j covering events [ends[j-1], ends[j]).
    """
    from .. import native

    m = len(events)
    events = np.ascontiguousarray(events, np.float32)
    bounds = ([0] if num_pos_events < 0 else [0, num_pos_events]) + [m]
    out = np.empty_like(events)
    ends_all = []
    if native.available():
        # A stable counting sort in C++, O(m + cells) per segment.
        h, w = image_shape
        hq, wq = -(-h // superpixel), -(-w // superpixel)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            out[lo:hi], ends = native.lut_cell_sort_segment(
                events[lo:hi], hq, wq, num_bins, superpixel)
            ends_all.append(lo + ends.astype(np.int64))
        return out, np.concatenate(ends_all).astype(np.int32)
    keys, num_cells = lut_cell_keys(events, image_shape, num_bins, superpixel)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        order = np.argsort(keys[lo:hi], kind="stable")
        out[lo:hi] = events[lo:hi][order]
        counts = np.bincount(keys[lo:hi], minlength=num_cells)
        ends_all.append(lo + np.cumsum(counts))
    return out, np.concatenate(ends_all).astype(np.int32)


def _voxel_grid_tnorm_numpy(x, y, t_norm, p, num_bins, height, width):
    """8-corner trilinear vote with t already in units of bins."""
    grid = np.zeros(num_bins * height * width, np.float64)
    value = 2.0 * p.astype(np.float64) - 1.0
    xf, yf, tf = np.floor(x), np.floor(y), np.floor(t_norm)
    for xlim in (xf, xf + 1):
        for ylim in (yf, yf + 1):
            for tlim in (tf, tf + 1):
                mask = ((xlim >= 0) & (xlim < width) & (ylim >= 0)
                        & (ylim < height) & (tlim >= 0) & (tlim < num_bins))
                w = (value * (1 - np.abs(xlim - x)) * (1 - np.abs(ylim - y))
                     * (1 - np.abs(tlim - t_norm)))
                idx = (tlim.astype(np.int64) * height
                       + ylim.astype(np.int64)) * width + xlim.astype(np.int64)
                grid += np.bincount(idx[mask], weights=w[mask],
                                    minlength=grid.size)
    return grid.reshape(num_bins, height, width).astype(np.float32)


def voxelize_normalized_host(events: np.ndarray, num_bins: int, height: int,
                             width: int, norm_type="mean_std",
                             quantile: float = 0.0) -> np.ndarray:
    """(y, x, t, p, bin[, valid]) rows with t in [0, 1] -> [nbins, H, W]:
    trilinear vote (native, f32 sums; else the NumPy twin, f64 sums),
    quantile clamp, then mean/std over the nonzero voxels (or max-abs)
    normalization."""
    from .. import native

    y = events[:, 0].astype(np.float32)
    x = events[:, 1].astype(np.float32)
    t_norm = events[:, 2].astype(np.float32) * (num_bins - 1)
    p = events[:, 3].astype(np.float32)
    if events.shape[1] > 5:
        keep = events[:, 5] > 0
        y, x, t_norm, p = y[keep], x[keep], t_norm[keep], p[keep]
    if native.available():
        grid = native.voxelize_trilinear(x, y, t_norm, p, num_bins, height,
                                         width)
    else:
        grid = _voxel_grid_tnorm_numpy(x, y, t_norm, p, num_bins, height,
                                       width)
    if quantile > 0:
        thr = np.quantile(np.abs(grid), 1.0 - quantile)
        grid = np.where(np.abs(grid) > thr,
                        np.sign(grid) * thr, grid).astype(np.float32)
    if norm_type == "max":
        mx = np.abs(grid).max()
        return grid / mx if mx > 0 else grid
    if norm_type == "mean_std":
        nz = grid != 0
        n = int(nz.sum())
        if n > 0:
            vals = grid[nz]
            mean = vals.mean(dtype=np.float64)
            var = (np.square(vals.astype(np.float64) - mean).sum()
                   / max(n - 1, 1))
            std = np.sqrt(var)
            grid = grid.copy()
            grid[nz] = ((vals - mean) / std if std > 0
                        else vals - mean).astype(np.float32)
        return grid
    if norm_type is not None:
        raise ValueError(f"unknown norm_type {norm_type!r}")
    return grid

"""Event rows, the voxel grid, the IWE vote, the 3x3 blur and the flow-LUT
gather (JAX: ops/events.py).

Events are fixed-capacity tensors [..., M, 6] with float32 rows
(y, x, t, p, bin, valid); padding rows carry valid = 0.  The voxel vote,
the IWE vote and the LUT gather's backward go through the hand-written
kernels of `ops/cuda/` (`voxel_vote.py`, `iwe_vote.py`, `lut_gather.py`,
`segment_sum.py`): on CUDA
tensors they launch the kernels, on CPU tensors they run the kernels' plain
versions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .cuda.iwe_vote import iwe_vote
from .cuda.lut_gather import lut_gather
from .cuda.segment_sum import grid_gather_any_order
from .cuda.voxel_vote import voxel_vote

EVENT_COLS = ("y", "x", "t", "p", "bin", "valid")
Y, X, T, P, BIN, VALID = range(6)

# torch.quantile refuses inputs of more elements than this.
_QUANTILE_MAX_ELEMENTS = 1 << 24


def voxel_grid_from_events(events: torch.Tensor, *, num_bins: int,
                           height: int, width: int) -> torch.Tensor:
    """[B, M, 6] rows with t in [0, 1] -> [B, num_bins, H, W] f32 trilinear
    voxel grids (JAX: voxel_grid_from_events on t_norm = t * (num_bins - 1),
    per sample): value (2p - 1) * valid, floor / floor + 1 taps, each axis
    masked to its range.  One call of the voxel-vote kernel on the card.
    """
    return voxel_vote(events, num_bins, height, width)


def clamp_voxel_grid_quantile(grids: torch.Tensor, quantile: float
                              ) -> torch.Tensor:
    """Symmetric clamp of each grid [..., nbins, H, W] at the (1 - quantile)
    quantile of its |values|; a no-op when quantile <= 0."""
    if quantile <= 0:
        return grids
    flat = grids.abs().reshape(*grids.shape[:-3], -1)
    if flat.shape[-1] > _QUANTILE_MAX_ELEMENTS:
        raise ValueError(
            f"voxel_quantile > 0 needs grids of at most 2^24 elements "
            f"(torch.quantile's limit); one grid here has {flat.shape[-1]}")
    thr = torch.quantile(flat, 1.0 - quantile, dim=-1)[..., None, None, None]
    return torch.where(grids.abs() > thr, torch.sign(grids) * thr, grids)


def normalize_voxel_grid(grids: torch.Tensor,
                         norm_type: Optional[str] = "mean_std"
                         ) -> torch.Tensor:
    """Normalize each grid [..., nbins, H, W]: 'mean_std' over its nonzero
    entries (std with Bessel's correction; zeros stay zero), 'max' by its
    largest |value|, None leaves it."""
    if norm_type is None:
        return grids
    dims = (-3, -2, -1)
    if norm_type == "max":
        mx = grids.abs().amax(dim=dims, keepdim=True)
        return torch.where(mx > 0, grids / torch.clamp(mx, min=1e-12), grids)
    if norm_type != "mean_std":
        raise ValueError(f"unknown norm_type {norm_type!r}")
    nz = (grids != 0).to(grids.dtype)
    n = nz.sum(dim=dims, keepdim=True)
    mean = (grids * nz).sum(dim=dims, keepdim=True) / torch.clamp(n, min=1.0)
    var = ((grids - mean).square() * nz).sum(dim=dims, keepdim=True) \
        / torch.clamp(n - 1.0, min=1.0)
    std = torch.sqrt(var)
    normed = torch.where(std > 0, (grids - mean) / std, grids - mean)
    return torch.where((n > 0) & (nz > 0), normed, grids)


def iwe_bilinear_vote(coords_yx: torch.Tensor, weight: torch.Tensor, *,
                      height: int, width: int) -> torch.Tensor:
    """Bilinear vote of [M, 2] (y, x) coords with [M] weights -> [H, W].

    The JAX `'direct'` semantics (ops/events.py:153-200): floor with a
    +1e-6 nudge, four corner votes, each corner masked to the image."""
    return iwe_vote(coords_yx[None], weight[None], height, width)[0]


def iwe_bilinear_vote_batch(coords_yx: torch.Tensor, weight: torch.Tensor, *,
                            height: int, width: int) -> torch.Tensor:
    """Batched vote: [B, M, 2], [B, M] -> [B, H, W] (one kernel launch)."""
    return iwe_vote(coords_yx, weight, height, width)


def stencil3(x: torch.Tensor, taps, dim: int, pad_mode: str) -> torch.Tensor:
    """3-tap 1-D cross-correlation along `dim` with zero ('constant') or
    'reflect' padding of one element; zero taps are skipped (JAX:
    ops/gradients.py::_stencil3)."""
    n = x.shape[dim]
    if pad_mode == "constant":
        edge = torch.zeros_like(x.narrow(dim, 0, 1))
        xp = torch.cat([edge, x, edge], dim=dim)
    elif pad_mode == "reflect":
        xp = torch.cat([x.narrow(dim, 1, 1), x, x.narrow(dim, n - 2, 1)],
                       dim=dim)
    else:
        raise ValueError(f"unknown pad_mode {pad_mode!r}")
    out = None
    for off, k in enumerate(taps):
        if k == 0:
            continue
        sl = xp.narrow(dim, off, n)
        term = sl if k == 1 else (-sl if k == -1 else k * sl)
        out = term if out is None else out + term
    return out


def gaussian_blur_3x3(images: torch.Tensor, sigma: float = 1.0
                      ) -> torch.Tensor:
    """Separable 3x3 gaussian blur with reflect padding over the last two
    dims (torchvision gaussian_blur(kernel_size=3, sigma), as the JAX
    package applies it to the IWE)."""
    x = np.array([-1.0, 0.0, 1.0])
    k1 = np.exp(-0.5 * (x / sigma) ** 2)
    k1 = k1 / k1.sum()
    taps = tuple(float(v) for v in k1)
    return stencil3(stencil3(images, taps, -2, "reflect"), taps, -1, "reflect")


def grid_gather(grid: torch.Tensor, rows_idx: torch.Tensor,
                cols_idx: torch.Tensor,
                cell_ends: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable per-event lookup grid[b, rows_idx, cols_idx, :].

    Args:
      grid: [B, R, X, C] f32 (the flow LUT: R = Hq * n_bins rows, y-major).
      rows_idx, cols_idx: [B, M] int32, pre-clipped to range.
      cell_ends: [B, S * R * X] int32 right boundaries of the events' runs
        of equal flat cell id rows * X + cols, events sorted within each of
        S segments (data/host_ops.py::lut_cell_sort).  Given, the lookup
        and its backward are the LUT-gather kernels (JAX 'pallas_sorted'
        forward, 'sorted_pallas' backward); None, events in any order: a
        plain gather whose backward is the any-order segment-sum kernel
        (JAX 'xla' forward, 'pallas' / 'native' backward).

    Returns:
      [B, M, C].
    """
    if cell_ends is not None:
        return lut_gather(grid, rows_idx, cols_idx, cell_ends)
    return grid_gather_any_order(grid, rows_idx, cols_idx)

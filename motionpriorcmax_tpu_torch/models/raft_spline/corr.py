"""Multi-target correlation volumes with per-target pyramid depth
(JAX: models/raft_spline/corr.py).

  * all-pairs volumes fmap1^T fmap2 / sqrt(D) for one reference against T
    targets: one batched matmul
  * per-target pyramid: level L keeps the targets with levels >= L, each
    2x2 average-pooled from its level L-1 volume
  * lookup: a (2r+1)^2 bilinear window around the curve-predicted coords at
    every level, through the corr-window kernels (ops/cuda/corr_window.py,
    forward and backward behind `CorrPyramidLookup`), written into
    [B, sum_l T_l * (2r+1)^2, h1, w1]

The volume's matmul and the pyramid's pooling are plain PyTorch, as the JAX
package leaves them to XLA; autograd carries their backward.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from ...ops.cuda.corr_window import CorrPyramidLookup
from ...utils import profiling

Pyramid = List[Tuple[Tuple[int, ...], torch.Tensor]]


def compute_corr_volume(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """All-pairs correlation: [B,D,h,w] x [T,B,D,h,w] -> [T,B,h*w,h,w] f32."""
    b, d, h, w = fmap1.shape
    t = fmap2.shape[0]
    f1 = fmap1.reshape(b, d, h * w).transpose(1, 2)          # [B, q, D]
    f2 = fmap2.reshape(t, b, d, h * w)                       # [T, B, D, p]
    corr = torch.matmul(f1[None], f2) / math.sqrt(d)         # [T, B, q, p]
    return corr.reshape(t, b, h * w, h, w)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool on the last two dims."""
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    return x.reshape(*lead, h // 2, 2, w // 2, 2).mean(dim=(-3, -1))


def build_corr_pyramid(corr: torch.Tensor,
                       num_levels_per_target: Sequence[int]) -> Pyramid:
    """[(target_indices, corr_level [T_l, B, h1*w1, h_l, w_l]), ...]."""
    levels = list(num_levels_per_target)
    if corr.shape[0] != len(levels):
        raise ValueError(f"{corr.shape[0]} targets but {len(levels)} levels")
    pyramid = [(tuple(range(len(levels))), corr)]
    for lvl in range(2, max(levels) + 1):
        keep = tuple(i for i, v in enumerate(levels) if v >= lvl)
        prev_idx, prev = pyramid[-1]
        sel = torch.stack([prev[prev_idx.index(i)] for i in keep], dim=0)
        pyramid.append((keep, _avg_pool2(sel)))
    return pyramid


def bilinear_sample_hw(img: torch.Tensor, x: torch.Tensor,
                       y: torch.Tensor) -> torch.Tensor:
    """Sample img [N, H, W] at fractional (x, y) [N, K]; zeros outside.

    Pixel-coordinate bilinear interpolation, equal to grid_sample with
    align_corners=True and padding_mode='zeros'.  A plain oracle for tests.
    """
    n, h, w = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.long()
    y0i = y0.long()
    flat = img.reshape(n, h * w)

    def corner(yi, xi, wgt):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        return torch.gather(flat, 1, idx) * wgt * inb.to(img.dtype)

    return (corner(y0i, x0i, (1 - fy) * (1 - fx))
            + corner(y0i, x0i + 1, (1 - fy) * fx)
            + corner(y0i + 1, x0i, fy * (1 - fx))
            + corner(y0i + 1, x0i + 1, fy * fx))


def lookup_corr_pyramid(pyramid: Pyramid, coords: torch.Tensor,
                        radius: int = 4) -> torch.Tensor:
    """Sample a (2r+1)^2 window per level and target around coords.

    Args:
      pyramid: from build_corr_pyramid.
      coords: [T0, B, 2, h1, w1], channel order (x, y), level-0 pixels.
      radius: lookup radius r.

    Returns:
      [B, sum_l T_l * (2r+1)^2, h1, w1] float32: level-major, then target,
      then (2r+1)^2 row-major over (dy, dx).  One forward kernel launch for
      all levels and, under autograd, one backward launch per level; the
      gradient reaches the volumes and `coords` (through the bilinear
      fractions; the per-level 1/2^l scale is torch's, outside the kernel).
      Counts its windows, sum_l T_l * B * h1 * w1, on `corr.windows`.
    """
    _, b, _, h1, w1 = coords.shape
    profiling.count("corr.windows",
                    sum(len(idx) for idx, _ in pyramid) * b * h1 * w1)
    tensors = [t for level in lookup_inputs(pyramid, coords) for t in level]
    return CorrPyramidLookup.apply(radius, h1, w1, *tensors)


def lookup_inputs(pyramid: Pyramid, coords: torch.Tensor
                  ) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """(corr_l, cx, cy) per level as the lookup kernels take them: the
    level's volume and its targets' window centres [T_l, B, h1*w1] at the
    level's scale."""
    _, b, _, h1, w1 = coords.shape
    levels = []
    for lvl, (target_idx, corr_l) in enumerate(pyramid):
        # Integer indexing + stack: indexing with a list would copy the index
        # to the card from pageable memory, which synchronizes the stream.
        sel = torch.stack([coords[i] for i in target_idx]) / (2.0 ** lvl)
        tl = len(target_idx)
        levels.append((corr_l,
                       sel[:, :, 0].reshape(tl, b, h1 * w1).contiguous(),
                       sel[:, :, 1].reshape(tl, b, h1 * w1).contiguous()))
    return levels

"""Curves as data: parameter tensors + evaluation functions
(JAX: models/raft_spline/curves.py).

  params:  [B, 2*degree, H, W]   (P0 == 0), viewed as [B, 2, degree, H, W];
           dim 0 of the view pairs with coords channel 0 = x
  flow(t): einsum(params_view, basis(t))
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch
from torch.nn import functional as F

from ...ops.basis import bernstein_basis

CURVE_TYPES = ("BEZIER", "POLYNOMIAL", "LEARNED")


def curve_params_init(batch: int, degree: int, height: int, width: int,
                      downsample_factor: int = 8,
                      device: Optional[torch.device] = None) -> torch.Tensor:
    """Zero curve parameters at 1/downsample resolution."""
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    return torch.zeros(batch, 2 * degree, height // downsample_factor,
                       width // downsample_factor, device=device)


def curve_basis_matrix(times: Union[Sequence[float], torch.Tensor],
                       degree: int, curve_type: str,
                       basis_apply: Optional[Callable] = None) -> torch.Tensor:
    """[T, degree] basis matrix for the given curve family.

    BEZIER: Bernstein with binomials; POLYNOMIAL: t^k, k = 1..degree;
    LEARNED: MLP(t) -> [T, degree].
    """
    times = torch.as_tensor(times, dtype=torch.float32)
    if curve_type == "BEZIER":
        return bernstein_basis(times, degree)
    if curve_type == "POLYNOMIAL":
        k = torch.arange(1, degree + 1, dtype=times.dtype, device=times.device)
        return times[:, None] ** k[None, :]
    if curve_type == "LEARNED":
        if basis_apply is None:
            raise ValueError("LEARNED curves need basis_apply")
        return basis_apply(times[:, None])
    raise ValueError(f"unknown curve_type {curve_type!r}")


def curve_flow_from_reference(params: torch.Tensor,
                              times: Union[Sequence[float], torch.Tensor],
                              curve_type: str = "BEZIER",
                              basis_apply: Optional[Callable] = None
                              ) -> torch.Tensor:
    """Flow from the reference frame at each time: [B, 2*deg, H, W] -> [T, B, 2, H, W]."""
    b, c, h, w = params.shape
    if c % 2:
        raise ValueError(f"params need an even channel count, got {c}")
    degree = c // 2
    if not isinstance(times, torch.Tensor):
        times = torch.tensor(times, dtype=torch.float32)
    basis = curve_basis_matrix(times.to(params.device), degree, curve_type,
                               basis_apply)
    pv = params.reshape(b, 2, degree, h, w)
    return torch.einsum("bdphw,tp->tbdhw", pv, basis.to(params.dtype))


def coords_grid(batch: int, ht: int, wd: int,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """[B, 2, H, W] pixel coordinate grid, channel order (x, y)."""
    gy, gx = torch.meshgrid(torch.arange(ht, dtype=torch.float32, device=device),
                            torch.arange(wd, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([gx, gy], dim=0)[None].expand(batch, 2, ht, wd)


def cvx_upsample(data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """RAFT convex 8x upsampling: softmax over 9 neighbours per output pixel.

    data [N, C, H, W] (scaled by 8: flow lives in upsampled pixels), mask
    [N, 9*64, H, W] -> [N, C, 8H, 8W].  F.unfold orders the 3x3 patch
    row-major over (dy, dx), with zero padding at the border.
    """
    n, dim, h, w = data.shape
    mask = torch.softmax(mask.reshape(n, 1, 9, 8, 8, h, w), dim=2)
    patches = F.unfold(8.0 * data, (3, 3), padding=1)
    patches = patches.reshape(n, dim, 9, 1, 1, h, w)
    up = torch.sum(mask * patches, dim=2)                 # [N, C, 8, 8, H, W]
    up = up.permute(0, 1, 4, 2, 5, 3)                     # [N, C, H, 8, W, 8]
    return up.reshape(n, dim, 8 * h, 8 * w)

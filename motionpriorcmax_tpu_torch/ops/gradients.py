"""Sobel gradients, Charbonnier and the focus / smoothness objectives
(JAX: ops/gradients.py).

Each mean over the batch takes a `mesh` (parallel.Mesh): given one, the
mean is that of the global batch, the group sum over the data axis of
this rank's (sum, count) divided out."""

from __future__ import annotations

from typing import Tuple

import torch

from .events import stencil3


def sobel_gradients(images: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel Sobel (grad_x, grad_y) of [B, C, H, W] with zero padding,
    computed separably as [-1, 0, 1] x [1, 2, 1] shifted adds."""
    smooth_h = stencil3(images, (1.0, 2.0, 1.0), -2, "constant")
    gx = stencil3(smooth_h, (-1.0, 0.0, 1.0), -1, "constant")
    smooth_w = stencil3(images, (1.0, 2.0, 1.0), -1, "constant")
    gy = stencil3(smooth_w, (-1.0, 0.0, 1.0), -2, "constant")
    return gx, gy


def batch_mean(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Mean of every element of x; with a mesh, over the global batch."""
    if mesh is None:
        return torch.mean(x)
    s = x.sum()
    sums = mesh.data_sum(torch.stack([s, torch.full_like(s, x.numel())]))
    return sums[0] / sums[1]


def gradient_magnitude(iwes: torch.Tensor, norm: str = "l2",
                       mesh=None) -> torch.Tensor:
    """Mean Sobel gradient magnitude of [B, H, W] or [B, C, H, W] IWEs."""
    if iwes.dim() == 3:
        iwes = iwes[:, None]
    dx, dy = sobel_gradients(iwes)
    if norm == "l2":
        return batch_mean(dx * dx + dy * dy, mesh)
    if norm == "l1":
        return batch_mean(dx.abs() + dy.abs(), mesh)
    raise ValueError(f"unknown norm {norm!r}")


def image_variance(iwes: torch.Tensor, mesh=None) -> torch.Tensor:
    """Mean per-image variance, Bessel-corrected (torch.var)."""
    n = iwes.shape[-1] * iwes.shape[-2]
    mean = torch.mean(iwes, dim=(-2, -1), keepdim=True)
    var = torch.sum((iwes - mean) ** 2, dim=(-2, -1)) / max(n - 1, 1)
    return batch_mean(var, mesh)


def focus_objective(iwes: torch.Tensor,
                    loss_type: str = "gradient_magnitude",
                    norm: str = "l2", epsilon: float = 0.0,
                    mesh=None) -> torch.Tensor:
    """1 / (sharpness + epsilon); epsilon 0 is the reference (an empty
    window then gives an infinite loss)."""
    if loss_type == "variance":
        val = image_variance(iwes, mesh)
    elif loss_type == "gradient_magnitude":
        val = gradient_magnitude(iwes, norm=norm, mesh=mesh)
    else:
        raise ValueError(f"unknown loss_type {loss_type!r}")
    return 1.0 / (val + epsilon)


def charbonnier(x: torch.Tensor, epsilon: float = 1e-3,
                mesh=None) -> torch.Tensor:
    return batch_mean(torch.sqrt(x * x + epsilon * epsilon), mesh)


def smoothness_loss(flow: torch.Tensor, mesh=None) -> torch.Tensor:
    """Charbonnier of the Sobel gradients of a [B, 2, H, W] flow."""
    dx, dy = sobel_gradients(flow)
    return (charbonnier(dx, mesh=mesh) + charbonnier(dy, mesh=mesh)) / 2.0

"""Optical-flow error math: EPE / NPE / AE (JAX: ops/flow_error.py)."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch


def calculate_flow_error(
    flow_gt: torch.Tensor,
    flow_pred: torch.Tensor,
    event_mask: Optional[torch.Tensor] = None,
    time_scale: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Flow error over GT-valid (finite, nonzero) pixels.

    valid = finite AND |u| > 0 AND |v| > 0, intersected with the optional
    event mask; per-image mean over valid pixels, then the batch mean.  AE is
    the Middlebury 3-vector angular error in degrees.

    Args:
      flow_gt, flow_pred: [B, 2, H, W].
      event_mask: optional [B, H, W] or [B, 1, H, W].
      time_scale: optional [B] multiplier on both flows.

    Returns:
      dict with 'EPE', '1PE', '2PE', '3PE', 'AE' scalars.
    """
    u_gt, v_gt = flow_gt[:, 0], flow_gt[:, 1]
    flow_mask = (torch.isfinite(u_gt) & torch.isfinite(v_gt)
                 & (u_gt.abs() > 0) & (v_gt.abs() > 0))       # [B, H, W]
    if event_mask is not None:
        if event_mask.dim() == 4:
            event_mask = event_mask[:, 0]
        flow_mask = flow_mask & (event_mask > 0)

    mask = flow_mask[:, None].to(flow_gt.dtype)                 # [B, 1, H, W]
    gt_masked = torch.where(torch.isfinite(flow_gt), flow_gt,
                            torch.zeros_like(flow_gt)) * mask
    pred_masked = flow_pred * mask
    n_points = mask.sum(dim=(1, 2, 3)) + 1e-5                   # [B]

    if time_scale is not None:
        ts = time_scale.reshape(-1, 1, 1, 1)
        gt_masked = gt_masked * ts
        pred_masked = pred_masked * ts

    err = torch.linalg.vector_norm(gt_masked - pred_masked, dim=1)
    errors = {"EPE": (err.sum(dim=(1, 2)) / n_points).mean()}
    for n in (1, 2, 3):
        errors[f"{n}PE"] = ((err > n).to(err.dtype).sum(dim=(1, 2))
                            / n_points).mean()

    u, v = pred_masked[:, 0], pred_masked[:, 1]
    ug, vg = gt_masked[:, 0], gt_masked[:, 1]
    cos_sim = (1.0 + u * ug + v * vg) / (
        torch.sqrt(1.0 + u * u + v * v) * torch.sqrt(1.0 + ug * ug + vg * vg))
    cos_sim = cos_sim.clamp(-1.0, 1.0)
    ae = (torch.arccos(cos_sim).sum(dim=(1, 2)) / n_points).mean()
    errors["AE"] = ae * (180.0 / math.pi)
    return errors

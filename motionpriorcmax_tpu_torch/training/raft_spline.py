"""RAFT-Spline model construction and validation step
(JAX: training/raft_spline.py).

  create_raft_model — RAFTSpline with weights drawn from an explicit
    generator, in eval mode on the requested device.
  raft_validation_step — forward in test mode, evaluate the upsampled curve
    at every GT flow timestamp, compute the plain / masked / ev-masked
    single and multi metrics and the linear-assumption baseline.

Training steps come with the RAFT training slice.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..device import resolve_device
from ..metrics.core import (ae_masked, ae_masked_multi, epe_masked,
                            epe_masked_multi, n_pixel_error_masked,
                            predictions_from_lin_assumption,
                            trajectory_flow_metrics)
from ..models.raft_spline import RAFTSpline, RAFTSplineConfig
from ..models.raft_spline.curves import curve_flow_from_reference
from ..models.raft_spline.raft import no_tf32
from ..ops.padding import pad_to_multiple, requires_padding, unpad


@torch.no_grad()
def _init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """torch's default layer init (uniform +-1/sqrt(fan_in)) drawn from
    `generator`; norms keep weight 1, bias 0, running stats (0, 1)."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            mod.weight.uniform_(-bound, bound, generator=generator)
            if mod.bias is not None:
                mod.bias.uniform_(-bound, bound, generator=generator)


def create_raft_model(cfg: RAFTSplineConfig, device=None,
                      generator: Optional[torch.Generator] = None
                      ) -> RAFTSpline:
    """RAFTSpline(cfg) in eval mode on `device` (default CUDA).

    Weights are drawn on the CPU from `generator` (a fresh one seeded 0 when
    None), so the same seed gives the same weights on every device.
    """
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = RAFTSpline(cfg)
    _init_weights(model, generator)
    return model.to(dev).eval()


def raft_validation_step(model: RAFTSpline, batch: Dict[str, torch.Tensor],
                         flow_timestamps: Sequence[float],
                         min_traj_len: Optional[float] = None,
                         max_traj_len: Optional[float] = None,
                         ) -> Dict[str, torch.Tensor]:
    """Evaluate the curve at each GT timestamp; compute the metric suite.

    Args:
      model: RAFTSpline in eval mode.
      batch: 'ev_repr' [B, nbins_total, H, W], 'flow' [B, M, 2, H, W]
        (channel 0 = x), optional 'flow_valid' [B, M, H, W], optional 'img'
        pair; all on the model's device.
      flow_timestamps: the M GT timestamps (EVIMO2: linspace(0,1,M+1)[1:]).
      min_traj_len, max_traj_len: optional GT-arc-length gate on the multi
        metrics.

    Returns:
      {'val/<metric>': value, 'val/<metric>__weight': weight, ...} tensors.
    """
    cfg = model.cfg
    # f32 throughout, the curve evaluation's einsum included.
    with torch.inference_mode(), no_tf32():
        ev_repr = batch["ev_repr"]
        images = batch.get("img")
        # Pad H, W to multiples of 8 around the forward; predictions are
        # pointwise in the upsampled params, so unpadding params_up equals
        # unpadding every predicted flow.
        h0, w0 = ev_repr.shape[-2:]
        padded = requires_padding(h0, w0, 8)
        if padded:
            ev_repr = pad_to_multiple(ev_repr, 8)
            if images is not None:
                images = [pad_to_multiple(x, 8) for x in images]
        _, params_up = model(ev_repr, images, test_mode=True)
        if padded:
            params_up = unpad(params_up, h0, w0, 8)

        ts = torch.tensor(list(flow_timestamps), dtype=torch.float32,
                          device=params_up.device)
        basis_apply = model.basis_mlp if cfg.curve_type == "LEARNED" else None
        preds = curve_flow_from_reference(params_up, ts, cfg.curve_type,
                                          basis_apply)     # [M, B, 2, H, W]
        gt = batch["flow"].movedim(1, 0)                    # [M, B, 2, H, W]

        event_mask = (batch["ev_repr"].abs() > 0).any(dim=1)  # [B, H, W]
        flow_valid = batch.get("flow_valid")
        if flow_valid is not None:
            valid = flow_valid.movedim(1, 0).bool()         # [M, B, H, W]
            masks_ev = valid & event_mask[None]
            masks = valid
        else:
            masks_ev = event_mask[None].expand(
                (gt.shape[0],) + tuple(event_mask.shape))
            masks = None

        logs: Dict[str, torch.Tensor] = {}

        def put(prefix, name, pair):
            logs[f"{prefix}{name}"] = pair[0]
            logs[f"{prefix}{name}__weight"] = pair[1]

        put("val/", "epe", epe_masked(preds[-1], gt[-1]))
        put("val/", "ae", ae_masked(preds[-1], gt[-1]))
        for n in (1, 2, 3):
            put("val/", f"{n}pe",
                n_pixel_error_masked(preds[-1], gt[-1], None, n))
        # The traj-len gate applies to EPE_MULTI and the trajectory metrics
        # only (AE_MULTI has no such option in the reference).
        tl = dict(min_traj_len=min_traj_len, max_traj_len=max_traj_len)
        put("val/", "epe_multi", epe_masked_multi(preds, gt, **tl))
        put("val/", "ae_multi", ae_masked_multi(preds, gt))
        for k, v in trajectory_flow_metrics(preds, gt, **tl).items():
            logs[f"val/{k}"] = v

        put("val/masked_", "epe", epe_masked(preds[-1], gt[-1], event_mask))
        put("val/masked_", "ae", ae_masked(preds[-1], gt[-1], event_mask))
        for n in (1, 2, 3):
            put("val/masked_", f"{n}pe",
                n_pixel_error_masked(preds[-1], gt[-1], event_mask, n))

        if masks is not None:
            put("val/masked_", "epe_multi",
                epe_masked_multi(preds, gt, masks, **tl))
            put("val/masked_", "ae_multi", ae_masked_multi(preds, gt, masks))
            for k, v in trajectory_flow_metrics(preds, gt, masks, **tl).items():
                logs[f"val/masked_{k}"] = v
        put("val/ev_masked_", "epe_multi",
            epe_masked_multi(preds, gt, masks_ev, **tl))
        put("val/ev_masked_", "ae_multi", ae_masked_multi(preds, gt, masks_ev))
        for k, v in trajectory_flow_metrics(preds, gt, masks_ev, **tl).items():
            logs[f"val/ev_masked_{k}"] = v

        preds_lin = predictions_from_lin_assumption(preds[-1], ts)
        put("val/", "epe_multi_lin", epe_masked_multi(preds_lin, gt))
        put("val/", "ae_multi_lin", ae_masked_multi(preds_lin, gt))
    return logs

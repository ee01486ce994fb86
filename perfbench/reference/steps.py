"""One training step of each model, and RAFT-Spline's answer to a request.

A step takes the model (train mode), its parameters by name, the
optimizer, the device batch (events [B, M, 6] with positives first at
`npos`; RAFT-Spline's 'ev_repr') and the reconstruction times, and
returns (loss, gradients by name).  The caller applies the optimizer.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import focus
from .nets import RAFTSpline, UNet, cvx_upsample, curve_flow, matmul_precision


def _grads(loss: torch.Tensor, params: Dict[str, torch.Tensor]
           ) -> Dict[str, torch.Tensor]:
    """d loss / d each parameter; zero for one the loss does not reach."""
    names = list(params)
    with matmul_precision("float32"):
        gs = torch.autograd.grad(loss, [params[k] for k in names],
                                 allow_unused=True)
    return {k: (torch.zeros_like(params[k]) if g is None else g)
            for k, g in zip(names, gs)}


def flow_step(model: UNet, params: Dict[str, torch.Tensor], loss_cfg: dict,
              model_cfg: dict, batch: Dict[str, torch.Tensor],
              times: torch.Tensor, npos: int
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The DSEC flow step: voxel grid of the batch's events -> UNet ->
    per-tile trajectories sum_k c_k (t^k - anchor^k) + tile centre ->
    focus loss."""
    h, w = loss_cfg["image_shape"]
    nb, k, ps = model_cfg["num_bins"], model_cfg["num_basis"], \
        model_cfg["patch_size"]
    events = batch["events"]
    with torch.no_grad():
        voxel = focus.voxel_grid(events, nb, h, w)
    coeff = model(voxel)                                  # [B, 2K, H, W]
    b = coeff.shape[0]
    sel = coeff[:, :, ps // 2::ps, ps // 2::ps]
    c = sel.reshape(b, 2, k, -1).transpose(-1, -2)        # [B, 2, N, K]
    t = times.to(coeff.device)
    powers = torch.arange(1, k + 1, dtype=t.dtype, device=t.device)
    anchor = model_cfg["anchor_time"] ** powers[None]
    basis = t[:, None] ** powers[None] - anchor
    traj = torch.einsum("bdnk,tk->btnd", c, basis)
    offsets = torch.from_numpy(focus.tile_positions((h, w), ps)).to(
        coeff.device)
    loss = focus.focus_loss(loss_cfg, traj + offsets[None, None], times,
                            events, npos)
    return loss, _grads(loss, params)


def raft_step(model: RAFTSpline, params: Dict[str, torch.Tensor],
              loss_cfg: dict, batch: Dict[str, torch.Tensor],
              times: torch.Tensor, npos: int
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The self-supervised RAFT-Spline step: the last iteration's
    upsampled curves, one trajectory per superpixel (the curve at its
    centre pixel), their focus loss."""
    s = loss_cfg["lut_superpixel_size"]
    params_seq, mask_seq = model(batch["ev_repr"])
    with matmul_precision(model.precision):
        up = cvx_upsample(params_seq[-1], mask_seq[-1])
        flows = curve_flow(up[:, :, s // 2::s, s // 2::s], times)  # [T,B,2,.]
        t_, b = flows.shape[:2]
        flows_yx = torch.stack([flows[:, :, 1], flows[:, :, 0]], dim=2)
        offsets = torch.from_numpy(focus.tile_positions(
            loss_cfg["image_shape"], s)).to(up.device)
        traj = offsets[None, None] + flows_yx.reshape(t_, b, 2, -1).permute(
            1, 0, 3, 2)
        loss = focus.focus_loss(loss_cfg, traj, times, batch["events"], npos)
    return loss, _grads(loss, params)


@torch.no_grad()
def raft_request(model: RAFTSpline, batch: Dict[str, torch.Tensor],
                 timestamps) -> Tuple[torch.Tensor, torch.Tensor]:
    """(full-resolution curve parameters [B, 2 deg, H, W], EPE of the
    last GT timestamp over all pixels) of one request, model in eval
    mode."""
    up = model.upsampled(batch["ev_repr"])
    ts = torch.tensor(list(timestamps), dtype=torch.float32)
    pred = curve_flow(up, ts)[-1]                         # [B, 2, H, W]
    epe = torch.sqrt(((pred - batch["flow"][:, -1]) ** 2).sum(dim=1)).mean()
    return up, epe

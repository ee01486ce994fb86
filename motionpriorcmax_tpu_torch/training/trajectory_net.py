"""TrajectoryNet: the self-supervised UNet flow workload
(JAX: training/trajectory_net.py).

  create_train_state(cfg, device, generator) -> TrainState (model + AdamW)
  train_step(state, batch, generator, cfg, loss_cfg, num_pos_events) -> logs
  eval_step(state, batch, generator, cfg, loss_cfg, ...)   -> logs + EPE/AE
  predict_flow(state, voxel, cfg)                          -> dense flow
  voxelize_batch_on_device(cfg, events)                    -> voxel grids

The JAX steps are pure functions of an immutable state; here `train_step`
updates the model and optimizer of `state` in place and returns the logs.
t_ref comes from an explicit torch.Generator (JAX draws it from
jax.random), or from `times` when a caller passes them.  `train_step(...,
mesh=)` is the step of one rank of a parallel.Mesh: it computes the
single-device step of the global batch from the rank's share of it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..device import no_tf32, resolve_device
from ..losses import FocusLossConfig, focus_loss, get_reconstruction_times
from ..models.basis_mlp import BasisMLP
from ..models.unet import UNet
from ..ops import events as ev_ops
from ..ops.basis import compute_trajectories, eval_basis
from ..ops.flow_error import calculate_flow_error
from ..ops.grids import (coeffs_grid_to_list, dense_flow_from_traj,
                         tile_mask_positions)
from ..parallel.mesh import sync_batch_norm
from ..utils import profiling
from .raft_spline import init_weights


@dataclasses.dataclass(frozen=True)
class TrajectoryNetConfig:
    """The JAX config's field names (config/flow_training/dsec.yaml after
    propagate_config).

    `unet_widths` is the port's own: the UNet's five widths, the
    reference's by default; the tests narrow them.  `voxel_norm_type` and
    `voxel_quantile` shape the voxel grids that a step builds on the device
    for a batch without a host 'voxel' (`voxelize_batch_on_device`).
    """

    image_shape: Tuple[int, int] = (480, 640)
    lr: float = 1e-4
    num_bins: int = 15
    num_basis: int = 1
    patch_size: int = 4
    model_type: str = "default"
    basis_type: str = "polynomial"   # dct | learned | polynomial
    skip_frames: int = 1
    anchor_time: float = 0.0
    voxel_norm_type: Optional[str] = "mean_std"
    voxel_quantile: float = 0.0
    compute_dtype: str = "float32"
    unet_widths: Tuple[int, ...] = (64, 128, 256, 512, 1024)


class TrajectoryModel(nn.Module):
    """UNet plus, for the learned basis, the basis MLP."""

    def __init__(self, cfg: TrajectoryNetConfig):
        super().__init__()
        if cfg.model_type != "default":
            raise ValueError(f"unknown model_type {cfg.model_type!r}")
        self.cfg = cfg
        self.unet = UNet(cfg.num_bins, 2 * cfg.num_basis,
                         widths=cfg.unet_widths,
                         compute_dtype=cfg.compute_dtype)
        self.basis_mlp = (BasisMLP(cfg.num_basis)
                          if cfg.basis_type == "learned" else None)

    def forward(self, voxel: torch.Tensor) -> torch.Tensor:
        """voxel [B, num_bins, H, W] -> coefficient grid [B, 2K, H, W] f32."""
        return self.unet(voxel)

    def basis(self, times: torch.Tensor) -> torch.Tensor:
        """times [T] -> basis matrix [T, K]."""
        return eval_basis(times, self.cfg.num_basis, self.cfg.basis_type,
                          mlp_apply=self.basis_mlp)


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the step count."""

    model: TrajectoryModel
    optimizer: Any
    step: int = 0


def make_optimizer(model: nn.Module, lr: float) -> torch.optim.AdamW:
    """AdamW with optax.adamw's defaults (b1 0.9, b2 0.999, eps 1e-8,
    weight decay 1e-4 on every parameter; torch's default decay is 1e-2)."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def create_train_state(cfg: TrajectoryNetConfig, device=None,
                       generator: Optional[torch.Generator] = None
                       ) -> TrainState:
    """TrajectoryModel with weights from `generator` (seed 0 when None),
    drawn on the CPU so every device gets the same weights, plus AdamW."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = TrajectoryModel(cfg)
    init_weights(model, generator)
    model = model.to(dev)
    return TrainState(model=model, optimizer=make_optimizer(model, cfg.lr))


def tile_offsets(cfg: TrajectoryNetConfig, device) -> torch.Tensor:
    """[N, 2] f32 (y, x) positions of the one-per-tile trajectories."""
    return torch.from_numpy(tile_mask_positions(
        cfg.image_shape, cfg.patch_size).astype(np.float32)).to(device)


def calculate_trajectories(cfg: TrajectoryNetConfig,
                           coeff_grid: torch.Tensor, times: torch.Tensor,
                           add_offsets: bool, basis_fn) -> torch.Tensor:
    """Coefficient grid [B, 2K, H, W] (or [B, S, 2K, H, W]) -> absolute
    positions [B, T, N, 2] at `times`, relative to the anchor time, plus
    the tile offsets when `add_offsets`."""
    if coeff_grid.dim() == 4:
        coeff_grid = coeff_grid[:, None]
    coeffs = coeffs_grid_to_list(coeff_grid, cfg.patch_size, cfg.num_basis)
    anchor = torch.full((1,), cfg.anchor_time, dtype=coeff_grid.dtype,
                        device=coeff_grid.device)
    traj = compute_trajectories(coeffs, basis_fn(times))
    traj = traj - compute_trajectories(coeffs, basis_fn(anchor))
    if add_offsets:
        traj = traj + tile_offsets(cfg, coeff_grid.device)[None, None]
    return traj


def flow_from_coeffs(cfg: TrajectoryNetConfig, coeff_grid: torch.Tensor,
                     basis_fn) -> torch.Tensor:
    """Dense flow anchor -> t_end [B, 2, H, W] from the coefficient grid."""
    if coeff_grid.dim() == 4:
        coeff_grid = coeff_grid[:, None]
    coeffs = coeffs_grid_to_list(coeff_grid, cfg.patch_size, cfg.num_basis)
    t_end = 1.0 if cfg.skip_frames == 1 else 1.0 / cfg.skip_frames
    ts = torch.tensor([cfg.anchor_time, t_end], dtype=coeff_grid.dtype,
                      device=coeff_grid.device)
    traj = compute_trajectories(coeffs, basis_fn(ts))
    dense, _ = dense_flow_from_traj(traj[:, 1] - traj[:, 0], cfg.patch_size,
                                    cfg.image_shape)
    return dense


def voxelize_batch_on_device(cfg: TrajectoryNetConfig,
                             events: torch.Tensor, mesh=None) -> torch.Tensor:
    """[B, M, 6] (y, x, t in [0, 1], p, bin, valid) -> [B, num_bins, H, W]
    voxel grids on the events' device (JAX: voxelize_batch_on_device with
    sorted_cell_size=None): the exact f32 trilinear vote (one voxel-vote
    kernel launch on the card, any event order), then per sample the
    quantile clamp and the mean_std / max normalization.

    It votes the batch's capacity-truncated events, where the host path
    votes every event of the window, as in the JAX package.  With a mesh,
    `events` are this rank's event shard: its partial grids are summed
    over the event axis before the clamp and the normalization."""
    h, w = cfg.image_shape
    with torch.no_grad(), profiling.scope("step.voxelize"):
        grids = ev_ops.voxel_grid_from_events(events, num_bins=cfg.num_bins,
                                              height=h, width=w)
        if mesh is not None:
            grids = mesh.event_sum(grids)
        grids = ev_ops.clamp_voxel_grid_quantile(grids, cfg.voxel_quantile)
        return ev_ops.normalize_voxel_grid(grids, cfg.voxel_norm_type)


def _step(model: TrajectoryModel, batch: Dict[str, torch.Tensor],
          loss_cfg: FocusLossConfig, times: torch.Tensor,
          num_pos_events: int, mesh=None):
    """voxel -> coefficients -> trajectories -> focus loss, in the model's
    current mode (train mode updates the BatchNorm statistics).

    A batch without 'voxel' is voxelized here from its events.  An unset
    `interp_band_per_bin` becomes True exactly for the linear basis
    (polynomial, num_basis 1), whose displacement grows linearly from the
    t = 0 anchor, as in the JAX step.  With a mesh, the batch is the
    rank's share and the BatchNorm statistics and the loss are those of
    the global batch (focus_loss's `mesh`)."""
    cfg = model.cfg
    if loss_cfg.interp_band_per_bin is None:
        loss_cfg = dataclasses.replace(loss_cfg, interp_band_per_bin=(
            cfg.basis_type == "polynomial" and cfg.num_basis == 1))
    voxel = batch.get("voxel")
    if voxel is None:
        voxel = voxelize_batch_on_device(cfg, batch["events"], mesh)
    with no_tf32(), sync_batch_norm(model, mesh):
        with profiling.scope("model.forward"):
            coeff_grid = model(voxel)
            traj = calculate_trajectories(cfg, coeff_grid, times,
                                          loss_cfg.is_needing_offsets,
                                          model.basis)
        loss, log_data, misc = focus_loss(
            loss_cfg, traj, times, batch["events"],
            num_pos_events=num_pos_events,
            cell_ends=batch.get("lut_cell_ends"), mesh=mesh)
    misc["coeff_grid"] = coeff_grid
    misc["traj"] = traj
    return loss, log_data, misc


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator],
               cfg: TrajectoryNetConfig, loss_cfg: FocusLossConfig,
               num_pos_events: int = -1,
               times: Optional[torch.Tensor] = None, mesh=None
               ) -> Dict[str, torch.Tensor]:
    """One AdamW step on `state` in place; returns the detached logs.

    `times` overrides the reconstruction times drawn from `generator`
    (tests pass the JAX side's).  With a mesh (parallel.Mesh), `batch` is
    this rank's share of the global batch (parallel.shard_batch or
    event_shard_batch), `num_pos_events` the global capacity, and
    `generator` must draw the same on every rank: the gradients are
    averaged over the world before the optimizer step, which then makes
    the single-device step of the global batch on every rank."""
    model = state.model
    if model.cfg != cfg:
        raise ValueError("state.model was built for another config")
    profiling.count("steps.train")
    with profiling.scope("step.train"):
        device = next(model.parameters()).device
        if times is None:
            times = get_reconstruction_times(loss_cfg, generator, device)
        model.train()
        with profiling.scope("step.optimizer"):
            state.optimizer.zero_grad(set_to_none=True)
        loss, log_data, misc = _step(model, batch, loss_cfg,
                                     times.to(device), num_pos_events, mesh)
        with no_tf32():
            profiling.backward(loss, misc["traj"])
        if mesh is not None:
            mesh.average_gradients(model.parameters())
        with profiling.scope("step.optimizer"):
            state.optimizer.step()
        state.step += 1
        logs = {"train_losses/total": loss.detach()}
        logs.update({f"train_losses/{k}": v for k, v in log_data.items()})
    return logs


@torch.no_grad()
def eval_step(state: TrainState, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator],
              cfg: TrajectoryNetConfig, loss_cfg: FocusLossConfig,
              num_pos_events: int = -1,
              times: Optional[torch.Tensor] = None
              ) -> Dict[str, torch.Tensor]:
    """Validation loss plus, with 'gt_flow' in the batch, EPE / NPE / AE
    over the pixels of 'flow_valid' (and 'event_mask' when given)."""
    model = state.model
    device = next(model.parameters()).device
    if times is None:
        times = get_reconstruction_times(loss_cfg, generator, device)
    model.eval()
    loss, log_data, misc = _step(model, batch, loss_cfg, times.to(device),
                                 num_pos_events)
    logs = {"val_losses/total": loss}
    logs.update({f"val_losses/{k}": v for k, v in log_data.items()})
    if "gt_flow" in batch:
        with no_tf32():
            flow_pred = flow_from_coeffs(cfg, misc["coeff_grid"], model.basis)
        mask = batch.get("flow_valid")
        event_mask = batch.get("event_mask")
        if mask is None:
            mask = event_mask
        elif event_mask is not None:
            if event_mask.dim() == 4:
                event_mask = event_mask[:, 0]
            if mask.dim() == 4:
                mask = mask[:, 0]
            mask = (mask > 0) & (event_mask > 0)
        errors = calculate_flow_error(batch["gt_flow"], flow_pred,
                                      event_mask=mask)
        logs.update({f"val_losses/{k}": v for k, v in errors.items()})
    return logs


@torch.no_grad()
def predict_flow(state: TrainState, voxel: torch.Tensor,
                 cfg: TrajectoryNetConfig) -> torch.Tensor:
    """Inference: voxel [B, num_bins, H, W] -> dense flow [B, 2, H, W]."""
    model = state.model
    model.eval()
    with no_tf32():
        return flow_from_coeffs(cfg, model(voxel), model.basis)

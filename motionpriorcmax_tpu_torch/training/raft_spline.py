"""RAFT-Spline model construction, training and validation steps
(JAX: training/raft_spline.py).

  create_raft_model — RAFTSpline with weights drawn from an explicit
    generator, in eval mode on the requested device.
  raft_validation_step — forward in test mode, evaluate the upsampled curve
    at every GT flow timestamp, compute the plain / masked / ev-masked
    single and multi metrics and the linear-assumption baseline.
  RAFTTrainConfig, make_optimizer, create_raft_train_state — AdamW with
    optax's weight decay, optax's linear one-cycle schedule and its
    MultiSteps gradient accumulation.
  raft_train_step — self-supervised: the focus loss on the predicted curves
    (final iteration, or gamma-weighted over all or a subsample of them).
  raft_supervised_train_step — gamma-weighted masked L1 against GT flow.

The JAX steps are pure functions of an immutable state; here the steps
update the model, optimizer and schedule of the state in place and return
the logs.  Random draws (t_ref, the gamma subsample) come from an explicit
torch.Generator, or from `times` / `sample_idx` when a caller passes them.
Both train steps take a `mesh` (parallel.Mesh): the step of one rank, from
its share of the global batch, that makes the single-device step of the
global batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..device import no_tf32, resolve_device
from ..losses import FocusLossConfig, focus_loss, get_reconstruction_times
from ..metrics.core import (ae_masked, ae_masked_multi, epe_masked,
                            epe_masked_multi, n_pixel_error_masked,
                            predictions_from_lin_assumption,
                            trajectory_flow_metrics)
from ..models.raft_spline import RAFTSpline, RAFTSplineConfig
from ..models.raft_spline.curves import (curve_flow_from_reference,
                                         cvx_upsample)
from ..ops.gradients import batch_mean
from ..ops.grids import tile_mask_positions
from ..ops.padding import pad_to_multiple, requires_padding, unpad
from ..parallel.mesh import sync_batch_norm
from ..utils import profiling


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """torch's default layer init (uniform +-1/sqrt(fan_in)) drawn from
    `generator`; norms keep weight 1, bias 0, running stats (0, 1)."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
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
    init_weights(model, generator)
    return model.to(dev).eval()


def boundary_images(batch: Dict[str, torch.Tensor]
                    ) -> Optional[Sequence[torch.Tensor]]:
    """The batch's boundary frames as the model takes them: the pair of
    [B, 3, H, W] views of the stacked 'img' [B, 2, 3, H, W] that every
    step's batch holds (collate.stack_samples, cli stack_traj_batch); None
    without."""
    img = batch.get("img")
    return None if img is None else img.unbind(1)


def raft_validation_step(model: RAFTSpline, batch: Dict[str, torch.Tensor],
                         flow_timestamps: Sequence[float],
                         min_traj_len: Optional[float] = None,
                         max_traj_len: Optional[float] = None,
                         iters: Optional[int] = None,
                         ) -> Dict[str, torch.Tensor]:
    """Evaluate the curve at each GT timestamp; compute the metric suite.

    Args:
      model: RAFTSpline in eval mode.
      batch: 'ev_repr' [B, nbins_total, H, W], 'flow' [B, M, 2, H, W]
        (channel 0 = x), optional 'flow_valid' [B, M, H, W], optional 'img'
        [B, 2, 3, H, W]; all on the model's device.
      flow_timestamps: the M GT timestamps (EVIMO2: linspace(0,1,M+1)[1:]).
      min_traj_len, max_traj_len: optional GT-arc-length gate on the multi
        metrics.
      iters: refinement iterations (model.cfg.iters when None; traj-train
        validates with the config's test count).

    Returns:
      {'val/<metric>': value, 'val/<metric>__weight': weight, ...} tensors.
    """
    cfg = model.cfg
    profiling.count("requests.eval")
    # f32 throughout, the curve evaluation's einsum included.
    with torch.inference_mode(), no_tf32(), profiling.scope("step.eval"):
        ev_repr = batch["ev_repr"]
        images = boundary_images(batch)
        # Pad H, W to multiples of 8 around the forward; predictions are
        # pointwise in the upsampled params, so unpadding params_up equals
        # unpadding every predicted flow.
        h0, w0 = ev_repr.shape[-2:]
        padded = requires_padding(h0, w0, 8)
        if padded:
            ev_repr = pad_to_multiple(ev_repr, 8)
            if images is not None:
                images = [pad_to_multiple(x, 8) for x in images]
        _, params_up = model(ev_repr, images, iters=iters, test_mode=True)
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


# -- training -----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RAFTTrainConfig:
    """The JAX config's fields: AdamW(learning_rate, weight_decay) with the
    one-cycle schedule over total_steps + 100 updates when use_scheduler;
    accumulate_steps > 1 averages that many steps' gradients per update."""

    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    use_scheduler: bool = True
    total_steps: int = 100000
    pct_start: float = 0.05
    accumulate_steps: int = 1

    def __post_init__(self):
        if self.accumulate_steps < 1:
            raise ValueError("accumulate_steps must be >= 1")


def onecycle_lr(tc: RAFTTrainConfig, count: int) -> float:
    """optax.linear_onecycle_schedule(tc.total_steps + 100, learning_rate,
    pct_start, pct_final=1.0) at update `count`.

    The rate rises linearly from lr / 25 to lr over the first
    int(pct_start * steps) updates, then falls linearly to lr * 1e-4 at
    `steps` and stays there.  (pct_final = 1.0 puts optax's second and
    third boundaries both at `steps`; its boundary dict keeps the last, so
    there is no return to lr / 25 in between.  torch's OneCycleLR places
    its phase boundaries one step apart from these.)
    """
    steps = tc.total_steps + 100
    bounds = (0, int(tc.pct_start * steps), steps)
    values = np.cumprod([tc.learning_rate / 25.0, 25.0, 1e-4])
    if count >= bounds[2]:
        return float(values[2])
    i = 1 if count >= bounds[1] else 0
    pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
    return float(pct * (values[i + 1] - values[i]) + values[i])


def make_optimizer(model: nn.Module, tc: RAFTTrainConfig):
    """(AdamW, LambdaLR or None): optax.adamw's betas, eps and decay on
    every parameter, and the one-cycle schedule stepped once per update."""
    opt = torch.optim.AdamW(model.parameters(), lr=tc.learning_rate,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=tc.weight_decay)
    if not tc.use_scheduler:
        return opt, None
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: onecycle_lr(tc, count) / tc.learning_rate)
    return opt, sched


@dataclasses.dataclass
class RAFTTrainState:
    """The model, its optimizer and schedule, the train steps taken, and
    the gradient mean of the steps since the last update (accumulation)."""

    model: RAFTSpline
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LambdaLR]
    tc: RAFTTrainConfig
    step: int = 0
    mini_step: int = 0
    acc_grads: Optional[List[torch.Tensor]] = None


def create_raft_train_state(cfg: RAFTSplineConfig, tc: RAFTTrainConfig,
                            device=None,
                            generator: Optional[torch.Generator] = None
                            ) -> RAFTTrainState:
    """create_raft_model's weights (seed 0 when no generator) plus AdamW."""
    model = create_raft_model(cfg, device, generator)
    opt, sched = make_optimizer(model, tc)
    return RAFTTrainState(model=model, optimizer=opt, scheduler=sched, tc=tc)


def _refuse_learned(cfg: RAFTSplineConfig, step: str) -> None:
    # The JAX steps evaluate the curve outside the model, without the basis
    # MLP: the supervised step refuses LEARNED curves, the self-supervised
    # step asserts in curve_basis_matrix.
    if cfg.curve_type == "LEARNED":
        raise ValueError(f"{step} evaluates the curve basis outside the "
                         "model and cannot train LEARNED curves")


def _apply_gradients(state: RAFTTrainState, loss: torch.Tensor,
                     mesh=None, split=None) -> None:
    """Backward (TF32 off) and, every accumulate_steps calls, one AdamW and
    schedule step on the running gradient mean (optax.MultiSteps).

    Parameters the loss does not reach get a zero gradient, so that AdamW
    decays them as optax does.  With a mesh, the gradients are averaged
    over the world first.  After an update `p.grad` holds the gradient
    that was applied.  `split`: the tensor, or tensors, the model handed
    to the loss, where `profiling.backward` splits the backward's spans."""
    params = list(state.model.parameters())
    with no_tf32():
        profiling.backward(loss, split)
    with profiling.scope("step.optimizer"):
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    if mesh is not None:
        mesh.average_gradients(params)
    state.step += 1
    k = state.tc.accumulate_steps
    if k > 1:
        if state.acc_grads is None:
            state.acc_grads = [torch.zeros_like(p) for p in params]
        for p, acc in zip(params, state.acc_grads):
            acc.add_((p.grad - acc) / (state.mini_step + 1))
        state.mini_step += 1
        if state.mini_step < k:
            return
        for p, acc in zip(params, state.acc_grads):
            p.grad.copy_(acc)
            acc.zero_()
        state.mini_step = 0
    with profiling.scope("step.optimizer"):
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()


def curve_focus_loss(cfg: RAFTSplineConfig, loss_cfg: FocusLossConfig,
                     params_up: torch.Tensor, times: torch.Tensor,
                     batch: Dict[str, torch.Tensor], num_pos_events: int,
                     mesh=None):
    """Focus loss of one full-resolution curve-parameter grid: one
    trajectory per superpixel (the grid sampled at its centre pixels),
    evaluated at `times`, channels (x, y) flipped to the loss's (y, x)."""
    s = loss_cfg.lut_superpixel_size
    with profiling.scope("loss.forward"):
        sel = params_up[:, :, s // 2::s, s // 2::s]       # [B, 2deg, Hn, Wn]
        flows = curve_flow_from_reference(sel, times, cfg.curve_type)
        t_, b = flows.shape[:2]
        flows_yx = torch.stack([flows[:, :, 1], flows[:, :, 0]], dim=2)
        offsets = torch.from_numpy(tile_mask_positions(
            loss_cfg.image_shape, s).astype(np.float32)).to(params_up.device)
        traj = offsets[None, None] + flows_yx.reshape(t_, b, 2, -1).permute(
            1, 0, 3, 2)                                      # [B, T, N, 2]
    return focus_loss(loss_cfg, traj, times, batch["events"],
                      num_pos_events=num_pos_events,
                      cell_ends=batch.get("lut_cell_ends"), mesh=mesh)


def raft_train_step(state: RAFTTrainState, batch: Dict[str, torch.Tensor],
                    generator: Optional[torch.Generator],
                    loss_cfg: FocusLossConfig, num_pos_events: int = -1,
                    gamma: Optional[float] = None,
                    gamma_sample_k: Optional[int] = None,
                    times: Optional[torch.Tensor] = None,
                    sample_idx: Optional[Sequence[int]] = None,
                    mesh=None) -> Dict[str, torch.Tensor]:
    """Self-supervised step: the focus loss on the predicted curves.

    gamma None scores the final iteration's upsampled curve (test-mode
    forward with train-mode BatchNorm).  gamma g scores every iteration,
    iteration i weighted g^(iters-1-i).  gamma_sample_k K (with gamma, 0 <
    K < iters - 1) scores the final iteration plus K of the others drawn
    without replacement, each reweighted by (iters-1)/K: an unbiased
    estimate of the full sum.

    Args:
      batch: 'ev_repr' [B, nbins_total, H, W], 'events' [B, M, 6], optional
        'lut_cell_ends' and 'img' [B, 2, 3, H, W], on the model's device.
      generator: draws t_ref (unless `times`) and the subsample (unless
        `sample_idx`, the K drawn iteration indices in [0, iters - 1)).
        With a mesh it must draw the same on every rank.
      mesh: a parallel.Mesh; `batch` is then the rank's share of the
        global batch and `num_pos_events` the global capacity.
    Returns the detached logs; the state is updated in place.
    """
    model = state.model
    cfg = model.cfg
    _refuse_learned(cfg, "raft_train_step")
    profiling.count("steps.train")
    with profiling.scope("step.train"):
        device = batch["ev_repr"].device
        if times is None:
            times = get_reconstruction_times(loss_cfg, generator, device)
        times = times.to(device)

        def score(params_up):
            return curve_focus_loss(cfg, loss_cfg, params_up, times, batch,
                                    num_pos_events, mesh)

        model.train()
        with profiling.scope("step.optimizer"):
            state.optimizer.zero_grad(set_to_none=True)
        split = None
        with no_tf32(), sync_batch_norm(model, mesh):
            if gamma is None:
                _, params_up = model(batch["ev_repr"], boundary_images(batch),
                                     test_mode=True)
                loss, log_data, _ = score(params_up)
                split = params_up
                logs = {f"train_losses/{k}": v for k, v in log_data.items()}
            else:
                params_seq, mask_seq = model(batch["ev_repr"],
                                             boundary_images(batch),
                                             return_sequences=True)
                n = params_seq.shape[0]
                if gamma_sample_k is not None and 0 < gamma_sample_k < n - 1:
                    k = gamma_sample_k
                    if sample_idx is None:
                        sample_idx = torch.randperm(
                            n - 1, generator=generator)[:k]
                    idx = [int(i) for i in sample_idx]
                    if len(idx) != k or len(set(idx)) != k or not all(
                            0 <= i < n - 1 for i in idx):
                        raise ValueError(
                            f"sample_idx must be {k} distinct iterations "
                            f"in [0, {n - 1}), got {idx}")
                    idx.append(n - 1)
                    scale = torch.full((k + 1,), (n - 1) / k, device=device)
                    scale[-1] = 1.0
                else:
                    idx = list(range(n))
                    scale = torch.ones(n, device=device)
                losses = torch.stack([score(cvx_upsample(params_seq[i],
                                                         mask_seq[i]))[0]
                                      for i in idx])
                expo = torch.tensor([n - 1 - i for i in idx],
                                    dtype=torch.float32, device=device)
                loss = torch.sum(gamma ** expo * scale * losses)
                logs = {"train_losses/focus_final": losses[-1].detach()}
        _apply_gradients(state, loss, mesh, split)
        logs["train_losses/total"] = loss.detach()
        return logs


def raft_supervised_train_step(state: RAFTTrainState,
                               batch: Dict[str, torch.Tensor],
                               gamma: float = 0.8, mesh=None
                               ) -> Dict[str, torch.Tensor]:
    """Supervised MultiFlow step: per iteration the masked L1 between the
    upsampled curve at the GT timestamps and the GT flow, iteration i
    weighted gamma^(iters-1-i).

    Args:
      batch: 'ev_repr' [B, nbins_total, H, W]; 'flow' [B, T, 2, H, W]
        (channel 0 = x); 'flow_timestamps' [B, T], one cadence for the
        batch (row 0 is used); optional 'flow_valid' [B, T, H, W] and
        'img' [B, 2, 3, H, W].
      mesh: a parallel.Mesh; `batch` is then the rank's share of the
        global batch, and each iteration's (masked) mean is taken over the
        global batch, sum(err * mask) / sum(mask) with both sums over the
        data axis.
    Returns the detached logs; the state is updated in place.
    """
    model = state.model
    cfg = model.cfg
    _refuse_learned(cfg, "raft_supervised_train_step")
    profiling.count("steps.train")
    with profiling.scope("step.train"):
        gt = batch["flow"].movedim(1, 0)                     # [T, B, 2, H, W]
        ts = batch["flow_timestamps"][0]
        valid = batch.get("flow_valid")
        vmask = (None if valid is None
                 else valid.movedim(1, 0)[:, :, None].float())
        model.train()
        with profiling.scope("step.optimizer"):
            state.optimizer.zero_grad(set_to_none=True)
        with no_tf32(), sync_batch_norm(model, mesh):
            params_seq, mask_seq = model(batch["ev_repr"],
                                         boundary_images(batch),
                                         return_sequences=True)
            with profiling.scope("loss.forward"):
                losses = []
                for p, m in zip(params_seq, mask_seq):
                    pred = curve_flow_from_reference(cvx_upsample(p, m), ts,
                                                     cfg.curve_type)
                    err = (pred - gt).abs()
                    if vmask is None:
                        losses.append(batch_mean(err, mesh))
                        continue
                    sums = torch.stack([torch.sum(err * vmask), vmask.sum()])
                    if mesh is not None:
                        sums = mesh.data_sum(sums)
                    losses.append(sums[0]
                                  / (2.0 * torch.clamp(sums[1], min=1.0)))
                losses = torch.stack(losses)
                n = losses.shape[0]
                expo = torch.arange(n - 1, -1, -1, dtype=losses.dtype,
                                    device=losses.device)
                loss = torch.sum(gamma ** expo * losses)
        _apply_gradients(state, loss, mesh, (params_seq, mask_seq))
        return {"train_losses/l1_final": losses[-1].detach(),
                "train_losses/total": loss.detach()}

"""Training loops, on one device or on each rank of a parallel.Mesh.

train_flow (JAX: training/loop.py::train_flow): per epoch, train steps
over the loader, then the image panel of five validation samples
(`make_flow_render_fn`, utils/image_logging.py) when given their dataset,
then a validation pass whose metrics accumulate on the device
(MetricBank), then a checkpoint kept by best-k retention on the monitored
metric (the reference's ModelCheckpoint(save_top_k=5,
monitor='val_losses/EPE')).

train_traj (JAX: cli/main.py::cmd_traj_train's loop): RAFT-Spline steps,
self-supervised or supervised, until max_steps; every val_every steps a
validation pass and a checkpoint kept by best-k on val/masked_TEPE, or,
without validation, a checkpoint every ckpt_every steps.

Scalars go to <workdir>/scalars.jsonl and, when the `tensorboard` package
is installed, to a TensorBoard event file under <workdir>/tb/.

With `mesh=` (one process per rank, JAX: train_flow's multi-host path)
each data rank's loader yields its batch // data samples
(`DataLoader(shard=(mesh.data_index, mesh.data))`), and each step cuts the
rank's event shard from them and makes the single-device step of the
global batch; validation runs on each rank's own shard of the val split
(`DataLoader(shard=(mesh.rank, mesh.world))`), its metric sums then
summed over the world (MetricBank.reduce_across_processes).  Rank 0 alone
writes the scalars, the image panel and the checkpoints, and the ranks
meet at a barrier after each checkpoint.  Validation then draws its t_ref
from a generator of its own, so that the train draws stay the same on
every rank whatever its val shard's length.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..device import no_tf32
from ..losses import FocusLossConfig, focus_loss, get_reconstruction_times
from ..metrics import MetricBank
from ..ops import events as ev_ops
from ..parallel import event_shard_batch, replicate
from ..utils import profiling
from ..utils.image_logging import ImagePanelLogger, log_flow_epoch_images
from .checkpoint import save_checkpoint
from .raft_spline import (RAFTTrainState, raft_supervised_train_step,
                          raft_train_step)
from .trajectory_net import (TrainState, TrajectoryNetConfig, _step,
                             calculate_trajectories, create_train_state,
                             eval_step, predict_flow, train_step,
                             voxelize_batch_on_device)

# Batch entries that stay on the host.
_HOST_KEYS = ("num_pos_events", "name", "timestamp", "file_index")


class ScalarLogger:
    """JSONL scalar log, one {"step": n, key: value, ...} object per line,
    mirrored to a TensorBoard SummaryWriter(<logdir>/tb) (`tb`; None when
    the `tensorboard` package is not installed)."""

    def __init__(self, logdir: str):
        self.path = Path(logdir)
        self.path.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path / "scalars.jsonl", "a")
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self.tb = SummaryWriter(str(self.path / "tb"))

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": step}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self.tb is not None:
            for k, v in rec.items():
                if k != "step":
                    self.tb.add_scalar(k, v, step)

    def close(self) -> None:
        self._fh.close()
        if self.tb is not None:
            self.tb.close()


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on `device` (host keys dropped); a
    forward_flow becomes gt_flow.

    A copy to a card goes from pinned host memory, so it runs on the
    current stream without holding the host: arrays the loader stacked
    into pinned memory (`DataLoader(pin_memory=True)`) are copied as they
    are, others through a pinned staging copy (torch's caching host
    allocator keeps it until the copy is done)."""
    dev = torch.device(device)
    out = {}
    with profiling.scope("batch.to_device"):
        for key, val in batch.items():
            if key in _HOST_KEYS:
                continue
            t = torch.from_numpy(np.asarray(val))
            if dev.type == "cuda" and not t.is_pinned():
                t = t.pin_memory()
            if key == "forward_flow":
                key = "gt_flow"
            profiling.count_h2d(t, dev)
            out[key] = t.to(dev, non_blocking=True)
    return out


def make_flow_render_fn(state: TrainState, loss_cfg: FocusLossConfig,
                        seed: int = 0, times: Optional[torch.Tensor] = None
                        ) -> Callable[[Dict], Dict[str, np.ndarray]]:
    """render(batch) of the image panel (JAX: training/loop.py::
    make_flow_render_fn) for a collated numpy batch of one sample; returns
    numpy arrays:
      unwarped_iwe  the bilinear vote of the raw events, 3x3 blurred;
      pred_iwe      the IWE of the eval-mode step (the positive half with
                    polarity-aware batching);
      pred_flow     `predict_flow` (a batch without 'voxel' voxelized on
                    the device first);
      gt_flow       the batch's forward_flow, when it has one; then, for
                    the polynomial basis with num_basis 1 only,
      gt_iwe        the focus loss's IWE of forward_flow taken as the
                    coefficient grid, with t_ref 0.
    Reconstruction times: `times`, else drawn once from a torch.Generator
    seeded `seed`.  Runs without autograd and with TF32 off, and leaves
    the model in the mode it found."""
    model = state.model
    cfg = model.cfg
    dev = next(model.parameters()).device
    h, w = loss_cfg.image_shape
    if times is None:
        times = get_reconstruction_times(
            loss_cfg, torch.Generator().manual_seed(seed))
    times = times.to(dev)

    def first_iwe(iwes: torch.Tensor) -> np.ndarray:
        return (iwes[0, 0, 0] if iwes.dim() == 5 else iwes[0, 0]).cpu().numpy()

    def render(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        was_training = model.training
        try:
            with torch.no_grad(), no_tf32():
                out = {}
                dev_batch = to_device(batch, dev)
                events = dev_batch["events"]
                # The vote's kernel reads rows of contiguous coordinates.
                out["unwarped_iwe"] = ev_ops.gaussian_blur_3x3(
                    ev_ops.iwe_bilinear_vote_batch(
                        events[..., :2].contiguous(),
                        events[..., 5].contiguous(), height=h,
                        width=w))[0].cpu().numpy()
                if "voxel" not in dev_batch:
                    dev_batch["voxel"] = voxelize_batch_on_device(cfg, events)
                npos = batch.get("num_pos_events", -1)
                model.eval()
                _, _, misc = _step(model, dev_batch, loss_cfg, times, npos)
                out["pred_iwe"] = first_iwe(misc["iwes"])
                out["pred_flow"] = predict_flow(
                    state, dev_batch["voxel"], cfg)[0].cpu().numpy()
                if "gt_flow" in dev_batch:
                    out["gt_flow"] = np.asarray(batch["forward_flow"][0])
                    if cfg.basis_type == "polynomial" and cfg.num_basis == 1:
                        gt_times = times.clone()
                        gt_times[0] = 0.0
                        traj = calculate_trajectories(
                            cfg, dev_batch["gt_flow"], gt_times, True,
                            model.basis)
                        _, _, misc_gt = focus_loss(loss_cfg, traj, gt_times,
                                                   events,
                                                   num_pos_events=npos)
                        out["gt_iwe"] = first_iwe(misc_gt["iwes"])
                return out
        finally:
            model.train(was_training)

    return render


def train_flow(cfg: TrajectoryNetConfig, loss_cfg: FocusLossConfig,
               train_loader: Iterable, val_loader: Optional[Iterable],
               workdir: str, *, device=None, max_epochs: int = 100,
               num_pos_events: int = -1, seed: int = 0,
               log_every: int = 200, monitor: str = "val_losses/EPE",
               resume_state: Optional[TrainState] = None,
               image_log_dataset=None,
               image_log_collate: Optional[Callable] = None,
               mesh=None) -> Dict[str, float]:
    """Self-supervised flow training; returns {'best', 'steps'}.

    Batches are numpy dicts from data/loader.py (cell-sorted events,
    'lut_cell_ends', a host 'voxel'); 'num_pos_events' in a batch
    overrides `num_pos_events`.  t_ref of each step comes from a
    torch.Generator seeded `seed + 1`.  With `image_log_dataset` and
    `image_log_collate` (collate_fn([sample]) -> batch), each epoch's
    training steps are followed by the image panel of five of its samples
    under <workdir>/images/ (and in TensorBoard), before validation.
    With `mesh`, the loaders are the rank's shards and the module
    docstring says what each rank does.
    """
    is_main = mesh is None or mesh.is_main
    logger = ScalarLogger(workdir) if is_main else None
    state = resume_state or create_train_state(
        cfg, device, torch.Generator().manual_seed(seed))
    if mesh is not None:
        replicate(mesh, state)
    dev = next(state.model.parameters()).device
    gen = torch.Generator().manual_seed(seed + 1)
    val_gen = gen if mesh is None else torch.Generator().manual_seed(seed + 2)
    best = float("inf")
    t_last = time.perf_counter()
    try:
        for _ in range(max_epochs):
            for batch in train_loader:
                npos = batch.get("num_pos_events", num_pos_events)
                if mesh is not None:
                    batch = event_shard_batch(mesh, batch, npos)
                logs = train_step(state, to_device(batch, dev), gen, cfg,
                                  loss_cfg, npos, mesh=mesh)
                if is_main and state.step % log_every == 0:
                    scalars = {k: float(v) for k, v in logs.items()}
                    now = time.perf_counter()
                    scalars["steps_per_s"] = log_every / (now - t_last)
                    t_last = now
                    logger.log(state.step, scalars)

            if (is_main and image_log_dataset is not None
                    and image_log_collate is not None):
                log_flow_epoch_images(
                    ImagePanelLogger(workdir, tb_writer=logger.tb),
                    image_log_dataset, image_log_collate,
                    make_flow_render_fn(state, loss_cfg), state.step, "val/")

            metric = None
            if val_loader is not None:
                bank = MetricBank()
                for batch in val_loader:
                    npos = batch.get("num_pos_events", num_pos_events)
                    bank.update_device(eval_step(
                        state, to_device(batch, dev), val_gen, cfg,
                        loss_cfg, npos))
                if mesh is not None:
                    bank = bank.reduce_across_processes()
                val = bank.compute()
                if is_main:
                    logger.log(state.step, val)
                metric = val.get(monitor, val.get("val_losses/total"))
            save_checkpoint(str(Path(workdir) / "checkpoints"), state,
                            step=state.step, metric=metric, mesh=mesh)
            if metric is not None and metric < best:
                best = metric
                if is_main:
                    logger.log(state.step,
                               {f"{k}_at_best": v for k, v in val.items()})
    finally:
        if is_main:
            logger.close()
    return {"best": best, "steps": state.step}


# Device batch entries of the two RAFT-Spline steps.
_TRAJ_KEYS = {"selfsup": ("ev_repr", "events", "lut_cell_ends"),
              "supervised": ("ev_repr", "flow", "flow_timestamps",
                             "flow_valid")}


def train_traj(state: RAFTTrainState, train_loader: Iterable, workdir: str,
               *, max_steps: int, loss_cfg: Optional[FocusLossConfig] = None,
               num_pos_events: int = -1, gamma: Optional[float] = None,
               gamma_sample_k: Optional[int] = None, log_every: int = 100,
               ckpt_every: int = 1000, val_every: int = 0,
               validate: Optional[Callable] = None, seed: int = 1,
               mesh=None) -> Dict[str, float]:
    """RAFT-Spline training until `max_steps`; returns {'best', 'steps'}.

    `loss_cfg` selects the self-supervised step (focus loss, `gamma` and
    `gamma_sample_k` as raft_train_step takes them); None the supervised
    step (gamma 0.8).  Batches are numpy dicts from data/loader.py; their
    'num_pos_events' overrides `num_pos_events`, and their boundary frames
    'img' reach the step when the model takes them.  t_ref and the gamma
    subsample come from a torch.Generator seeded `seed`.

    `validate(model) -> {metric: float}` runs in eval mode every
    `val_every` steps and after the last; its val/masked_TEPE (else
    val/epe) is the checkpoint's metric for best-k retention.  Without
    `validate`, a checkpoint every `ckpt_every` steps and after the last.

    With `mesh`, the loader is the rank's data shard and `validate` the
    rank's share of the validation (its metrics the same on every rank,
    as the CLI's run_traj_validation with `shard` and `reduce` gives
    them); the module docstring says the rest.
    """
    kind = "supervised" if loss_cfg is None else "selfsup"
    is_main = mesh is None or mesh.is_main
    logger = ScalarLogger(workdir) if is_main else None
    if mesh is not None:
        replicate(mesh, state)
    dev = next(state.model.parameters()).device
    gen = torch.Generator().manual_seed(seed)
    keys = _TRAJ_KEYS[kind] + (("img",) if state.model.cfg.use_boundary_images
                               else ())
    ckpt_dir = str(Path(workdir) / "checkpoints")
    best = float("inf")
    n_steps = 0

    def run_validation():
        nonlocal best
        state.model.eval()
        val = validate(state.model)
        if is_main:
            logger.log(n_steps, val)
        metric = val.get("val/masked_TEPE", val.get("val/epe"))
        save_checkpoint(ckpt_dir, state, step=n_steps, metric=metric,
                        mesh=mesh)
        if metric is not None and metric < best:
            best = metric
            if is_main:
                logger.log(n_steps,
                           {f"{k}_at_best": v for k, v in val.items()})

    try:
        while n_steps < max_steps:
            epoch_steps = n_steps
            for batch in train_loader:
                npos = batch.get("num_pos_events", num_pos_events)
                batch = {k: batch[k] for k in keys if k in batch}
                if mesh is not None:
                    batch = event_shard_batch(mesh, batch, npos)
                dev_batch = to_device(batch, dev)
                if loss_cfg is None:
                    logs = raft_supervised_train_step(state, dev_batch,
                                                      mesh=mesh)
                else:
                    logs = raft_train_step(
                        state, dev_batch, gen, loss_cfg, npos, gamma,
                        gamma_sample_k, mesh=mesh)
                n_steps += 1
                if is_main and n_steps % log_every == 0:
                    logger.log(n_steps, {k: float(v) for k, v in logs.items()})
                if validate is not None:
                    if n_steps % val_every == 0 or n_steps >= max_steps:
                        run_validation()
                elif n_steps % ckpt_every == 0 or n_steps >= max_steps:
                    save_checkpoint(ckpt_dir, state, step=n_steps, mesh=mesh)
                if n_steps >= max_steps:
                    break
            if n_steps == epoch_steps:
                raise ValueError("the training loader yielded no batch")
    finally:
        if is_main:
            logger.close()
    return {"best": best, "steps": n_steps}

"""Training loops on one device.

train_flow (JAX: training/loop.py::train_flow): per epoch, train steps
over the loader, then a validation pass whose metrics accumulate on the
device (MetricBank), then a checkpoint kept by best-k retention on the
monitored metric (the reference's ModelCheckpoint(save_top_k=5,
monitor='val_losses/EPE')).

train_traj (JAX: cli/main.py::cmd_traj_train's loop): RAFT-Spline steps,
self-supervised or supervised, until max_steps; every val_every steps a
validation pass and a checkpoint kept by best-k on val/masked_TEPE, or,
without validation, a checkpoint every ckpt_every steps.

Scalars go to <workdir>/scalars.jsonl.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..losses import FocusLossConfig
from ..metrics import MetricBank
from .checkpoint import save_checkpoint
from .raft_spline import (RAFTTrainState, raft_supervised_train_step,
                          raft_train_step)
from .trajectory_net import (TrainState, TrajectoryNetConfig,
                             create_train_state, eval_step, train_step)

# Batch entries that stay on the host.
_HOST_KEYS = ("num_pos_events", "name", "timestamp", "file_index")


class ScalarLogger:
    """JSONL scalar log, one {"step": n, key: value, ...} object per line."""

    def __init__(self, logdir: str):
        self.path = Path(logdir)
        self.path.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path / "scalars.jsonl", "a")

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": step}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on `device` (host keys dropped); a
    forward_flow becomes gt_flow and flow_valid a bool mask."""
    out = {}
    for key, val in batch.items():
        if key in _HOST_KEYS:
            continue
        t = torch.from_numpy(np.asarray(val))
        if key == "forward_flow":
            key = "gt_flow"
        out[key] = t.to(device, non_blocking=True)
    return out


def train_flow(cfg: TrajectoryNetConfig, loss_cfg: FocusLossConfig,
               train_loader: Iterable, val_loader: Optional[Iterable],
               workdir: str, *, device=None, max_epochs: int = 100,
               num_pos_events: int = -1, seed: int = 0,
               log_every: int = 200, monitor: str = "val_losses/EPE",
               resume_state: Optional[TrainState] = None
               ) -> Dict[str, float]:
    """Self-supervised flow training; returns {'best', 'steps'}.

    Batches are numpy dicts from data/loader.py (cell-sorted events,
    'lut_cell_ends', a host 'voxel'); 'num_pos_events' in a batch
    overrides `num_pos_events`.  t_ref of each step comes from a
    torch.Generator seeded `seed + 1`.
    """
    logger = ScalarLogger(workdir)
    state = resume_state or create_train_state(
        cfg, device, torch.Generator().manual_seed(seed))
    dev = next(state.model.parameters()).device
    gen = torch.Generator().manual_seed(seed + 1)
    best = float("inf")
    t_last = time.perf_counter()
    try:
        for _ in range(max_epochs):
            for batch in train_loader:
                npos = batch.get("num_pos_events", num_pos_events)
                logs = train_step(state, to_device(batch, dev), gen, cfg,
                                  loss_cfg, npos)
                if state.step % log_every == 0:
                    scalars = {k: float(v) for k, v in logs.items()}
                    now = time.perf_counter()
                    scalars["steps_per_s"] = log_every / (now - t_last)
                    t_last = now
                    logger.log(state.step, scalars)

            metric = None
            if val_loader is not None:
                bank = MetricBank()
                for batch in val_loader:
                    npos = batch.get("num_pos_events", num_pos_events)
                    bank.update_device(eval_step(
                        state, to_device(batch, dev), gen, cfg, loss_cfg,
                        npos))
                val = bank.compute()
                logger.log(state.step, val)
                metric = val.get(monitor, val.get("val_losses/total"))
            save_checkpoint(str(Path(workdir) / "checkpoints"), state,
                            step=state.step, metric=metric)
            if metric is not None and metric < best:
                best = metric
                logger.log(state.step,
                           {f"{k}_at_best": v for k, v in val.items()})
    finally:
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
               validate: Optional[Callable] = None, seed: int = 1
               ) -> Dict[str, float]:
    """RAFT-Spline training until `max_steps`; returns {'best', 'steps'}.

    `loss_cfg` selects the self-supervised step (focus loss, `gamma` and
    `gamma_sample_k` as raft_train_step takes them); None the supervised
    step (gamma 0.8).  Batches are numpy dicts from data/loader.py; their
    'num_pos_events' overrides `num_pos_events`.  t_ref and the gamma
    subsample come from a torch.Generator seeded `seed`.

    `validate(model) -> {metric: float}` runs in eval mode every
    `val_every` steps and after the last; its val/masked_TEPE (else
    val/epe) is the checkpoint's metric for best-k retention.  Without
    `validate`, a checkpoint every `ckpt_every` steps and after the last.
    """
    kind = "supervised" if loss_cfg is None else "selfsup"
    logger = ScalarLogger(workdir)
    dev = next(state.model.parameters()).device
    gen = torch.Generator().manual_seed(seed)
    ckpt_dir = str(Path(workdir) / "checkpoints")
    best = float("inf")
    n_steps = 0

    def run_validation():
        nonlocal best
        state.model.eval()
        val = validate(state.model)
        logger.log(n_steps, val)
        metric = val.get("val/masked_TEPE", val.get("val/epe"))
        save_checkpoint(ckpt_dir, state, step=n_steps, metric=metric)
        if metric is not None and metric < best:
            best = metric
            logger.log(n_steps, {f"{k}_at_best": v for k, v in val.items()})

    try:
        while n_steps < max_steps:
            epoch_steps = n_steps
            for batch in train_loader:
                dev_batch = to_device({k: batch[k] for k in _TRAJ_KEYS[kind]
                                       if k in batch}, dev)
                if loss_cfg is None:
                    logs = raft_supervised_train_step(state, dev_batch)
                else:
                    logs = raft_train_step(
                        state, dev_batch, gen, loss_cfg,
                        batch.get("num_pos_events", num_pos_events), gamma,
                        gamma_sample_k)
                n_steps += 1
                if n_steps % log_every == 0:
                    logger.log(n_steps, {k: float(v) for k, v in logs.items()})
                if validate is not None:
                    if n_steps % val_every == 0 or n_steps >= max_steps:
                        run_validation()
                elif n_steps % ckpt_every == 0 or n_steps >= max_steps:
                    save_checkpoint(ckpt_dir, state, step=n_steps)
                if n_steps >= max_steps:
                    break
            if n_steps == epoch_steps:
                raise ValueError("the training loader yielded no batch")
    finally:
        logger.close()
    return {"best": best, "steps": n_steps}

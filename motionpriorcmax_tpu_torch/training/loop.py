"""Flow-training loop on one device (JAX: training/loop.py::train_flow).

Per epoch: train steps over the loader, then a validation pass whose
metrics accumulate on the device (MetricBank), then a checkpoint kept by
best-k retention on the monitored metric (the reference's
ModelCheckpoint(save_top_k=5, monitor='val_losses/EPE')).  Scalars go to
<workdir>/scalars.jsonl.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..losses import FocusLossConfig
from ..metrics import MetricBank
from .checkpoint import save_checkpoint
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

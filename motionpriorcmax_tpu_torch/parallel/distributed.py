"""Process-group set-up and the rank's share of a batch (JAX:
parallel/distributed.py).

Every process runs the same command with its own process id:

  1. `initialize_distributed` joins the process group (NCCL for cards,
     gloo for the CPU, or the backend the caller names) and returns the
     process's device, cuda:{process_id % device_count} on cards;
  2. `mesh.make_mesh` lays the world out as a (data, event) mesh;
  3. each data rank loads its own batch // data samples
     (`data.loader.DataLoader(shard=(data_index, data))`), and
     `event_shard_batch` cuts its event shard out of them.
"""

from __future__ import annotations

import datetime
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device="cuda",
                           timeout_s: float = 1800.0) -> torch.device:
    """Join the process group; return this process's device.

    One process without a coordinator joins nothing (the single-device
    path).  Otherwise `init_process_group(init_method=
    f"tcp://{coordinator_address}")` with `num_processes` ranks, this one
    `process_id`, over `backend`: NCCL for a CUDA device and gloo for the
    CPU unless the caller names one (gloo also carries CUDA tensors, so
    several ranks can share one card, which NCCL refuses).  A rank on
    cards uses cuda:{process_id % torch.cuda.device_count()}.  Collectives
    that wait longer than `timeout_s` raise.
    """
    dev = resolve_device(device)
    if num_processes in (None, 1) and coordinator_address is None:
        return dev
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("several processes need coordinator_address, "
                         "num_processes and process_id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside "
                         f"[0, {num_processes})")
    if dev.type == "cuda":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def process_batch_slice(global_batch: int, mesh) -> slice:
    """The [start, stop) rows of the global batch that `mesh`'s data rank
    holds."""
    per = global_batch // mesh.data
    if per * mesh.data != global_batch:
        raise ValueError(f"batch {global_batch} does not split over "
                         f"{mesh.data} data ranks")
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def _cat(parts):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=1)
    return np.concatenate(parts, axis=1)


def _clip(x, lo, hi):
    if isinstance(x, torch.Tensor):
        return torch.clamp(x, lo, hi)
    return np.clip(x, lo, hi)


def shard_events(mesh, events, num_pos_events: int = -1, cell_ends=None):
    """This rank's event shard of a data rank's [B, M, 6] events, and its
    LUT-cell boundaries (JAX: event_parallel.py:68-107); numpy arrays or
    tensors.

    Positives-first events (num_pos_events >= 0) keep that layout: the
    shard is the rank's slice of the positives followed by its slice of
    the negatives, M / event rows with num_pos_events / event positives.
    `cell_ends` [B, S * cells], the global right boundaries of the cell
    runs (S = 2 with positives first), become the shard's own: each
    segment's boundaries shifted by the shard's start in it and clipped
    into the shard.  A contiguous slice of cell-sorted events is
    cell-sorted, so the shard's runs are the global runs cut to it.
    """
    n = mesh.event
    m = events.shape[1]
    if m % n:
        raise ValueError(f"event capacity {m} does not split over {n} "
                         "event ranks")
    if n == 1:
        return events, cell_ends
    e = mesh.event_index
    lm = m // n
    if num_pos_events < 0:
        local = events[:, e * lm:(e + 1) * lm]
        ends = (None if cell_ends is None
                else _clip(cell_ends - e * lm, 0, lm))
        return local, ends
    if num_pos_events % n:
        raise ValueError(
            "event sharding with positives first needs positive and "
            f"negative capacities that split over {n} event ranks; got "
            f"{num_pos_events} positives of {m}")
    pm, nm = num_pos_events // n, (m - num_pos_events) // n
    local = _cat([events[:, e * pm:(e + 1) * pm],
                  events[:, num_pos_events + e * nm:
                         num_pos_events + (e + 1) * nm]])
    ends = None
    if cell_ends is not None:
        cells = cell_ends.shape[1] // 2
        ends = _cat([_clip(cell_ends[:, :cells] - e * pm, 0, pm),
                     pm + _clip(cell_ends[:, cells:] - num_pos_events
                                - e * nm, 0, nm)])
    return local, ends


def event_shard_batch(mesh, batch: Dict[str, Any], num_pos_events: int = -1
                      ) -> Dict[str, Any]:
    """A data rank's local batch (numpy arrays or tensors) with 'events'
    and 'lut_cell_ends' replaced by this rank's event shard
    (`shard_events`); every other entry, 'num_pos_events' included (the
    global capacity, which the steps take), is left as it is.  The
    batch's own 'num_pos_events' wins over the argument."""
    if mesh.event == 1 or "events" not in batch:
        return batch
    npos = int(batch.get("num_pos_events", num_pos_events))
    events, ends = shard_events(mesh, batch["events"], npos,
                                batch.get("lut_cell_ends"))
    out = dict(batch, events=events)
    if ends is not None:
        out["lut_cell_ends"] = ends
    return out


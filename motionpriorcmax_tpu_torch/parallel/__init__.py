"""Multi-process training over a (data, event) mesh (JAX: parallel/).

One process per card (or, over gloo, several on one card or on the CPU),
joined by torch.distributed:

  initialize_distributed  the process group and this process's device
  make_mesh               the (data, event) mesh and its process groups
  replicate               rank 0's parameters, buffers and optimizer state
                          on every rank
  shard_batch             a global batch -> this rank's data slice and
                          event shard
  event_shard_batch       a data rank's local batch -> this rank's event
                          shard (the counterpart of JAX's
                          host_local_batch_to_global)
  focus_loss_event_sharded  the focus loss with the event axis split

A sharded step computes the single-device step's function on the global
batch (see mesh.py), not an average of per-rank losses.  JAX's
make_sharded_train_step has no counterpart: the port's train steps take
the mesh themselves (`train_step(..., mesh=)`, `raft_train_step`,
`raft_supervised_train_step`).
"""

from .distributed import (event_shard_batch, initialize_distributed,
                          process_batch_slice, shard_events)
from .event_parallel import focus_loss_event_sharded
from .mesh import Mesh, make_mesh, replicate, shard_batch, sync_batch_norm

__all__ = [
    "Mesh",
    "event_shard_batch",
    "focus_loss_event_sharded",
    "initialize_distributed",
    "make_mesh",
    "process_batch_slice",
    "replicate",
    "shard_batch",
    "shard_events",
    "sync_batch_norm",
]

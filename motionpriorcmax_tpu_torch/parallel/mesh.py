"""The (data, event) mesh of a torch.distributed world (JAX:
parallel/mesh.py).

Rank r of a world of data x event ranks sits at data index r // event and
event index r % event, as JAX reshapes its devices to (data, event):

  * parameters, buffers and optimizer state: replicated (`replicate`);
  * batch entries: split over 'data', batch // data samples per data rank;
  * events [B, M, 6]: the event ranks of one data index hold the same
    samples and split their event capacity (`distributed.shard_events`);
    each votes a partial IWE (and a partial voxel grid), and the partials
    are summed over the event group before anything nonlinear.

A sharded step computes the single-device step's function on the global
batch, as JAX's jit with shardings does; it is not DDP's average of
per-rank losses.  Every reduction over the batch is therefore a group sum
of per-rank partial sums: the BatchNorm statistics (`sync_batch_norm`),
the focus objective's and the smoothness term's means, the supervised
loss's masked mean.  Each group sum (`Mesh.data_sum`, `Mesh.event_sum`)
is an all-reduce whose backward all-reduces the cotangents.  With every such collective having
that adjoint and the loss equal on every rank, rank r's autograd computes
d(sum over ranks of L) / d(rank r's copy of theta) = world x (rank r's
share of dL/dtheta), and the shares add up to dL/dtheta: one average of
the gradients over the world before the optimizer step
(`Mesh.average_gradients`) gives the single-device gradient, for work
split over ranks and replicated work (the UNet on event ranks, the flow
LUT) alike.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..models.norm import FlaxBatchNorm2d
from .distributed import event_shard_batch, process_batch_slice


class _GroupSum(torch.autograd.Function):
    """y = sum over the group's ranks of x; the cotangent of x is the sum
    over the ranks of the cotangents of y (the all-reduce's adjoint)."""

    @staticmethod
    def forward(ctx, x, mesh, group):
        ctx.mesh, ctx.group = mesh, group
        return mesh._all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh._all_reduce(grad.contiguous().clone(),
                                    ctx.group), None, None


class Mesh:
    """A rank's place in the (data, event) mesh and its process groups.

    `data_group` joins the ranks of this event index (they hold different
    samples), `event_group` the ranks of this data index (they hold the
    same samples and split their events); the world is the default
    group.  `reduced_bytes` counts the bytes this rank has passed to
    all-reduces, forward and backward."""

    def __init__(self, data: int, event: int, rank: int, data_group,
                 event_group, backend: str):
        self.data, self.event = data, event
        self.world = data * event
        self.rank = rank
        self.data_index, self.event_index = divmod(rank, event)
        self.data_group, self.event_group = data_group, event_group
        self.backend = backend
        # NCCL reduces tensors on the rank's card only.
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if backend == "nccl" else None)
        self.reduced_bytes = 0

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def _all_reduce(self, t: torch.Tensor, group) -> torch.Tensor:
        self.reduced_bytes += t.numel() * t.element_size()
        if self.device is not None and t.device != self.device:
            buf = t.to(self.device)
            dist.all_reduce(buf, group=group)
            return t.copy_(buf)
        dist.all_reduce(t, group=group)
        return t

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable sum of x over the data axis (the identity on a
        data axis of one)."""
        return x if self.data == 1 else _GroupSum.apply(x, self,
                                                        self.data_group)

    def event_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable sum of x over the event axis."""
        return x if self.event == 1 else _GroupSum.apply(x, self,
                                                         self.event_group)

    def local_capacity(self, capacity: int) -> int:
        """A static per-sample event capacity (of the data rank's events)
        -> one event rank's share; a negative (unused) capacity stays."""
        if capacity < 0:
            return capacity
        if capacity % self.event:
            raise ValueError(f"capacity {capacity} does not split over "
                             f"{self.event} event ranks")
        return capacity // self.event

    def _coalesced(self, tensors: List[torch.Tensor], op) -> None:
        """op(flat) on one flat buffer per (device, dtype), copied back."""
        buckets: Dict[Any, List[torch.Tensor]] = {}
        for t in tensors:
            buckets.setdefault((t.device, t.dtype), []).append(t)
        for group in buckets.values():
            flat = _flatten_dense_tensors(group)
            op(flat)
            for t, v in zip(group, _unflatten_dense_tensors(flat, group)):
                t.copy_(v)

    def average_gradients(self, params: Iterable[torch.Tensor]) -> None:
        """Every parameter's .grad := its mean over the world, in one
        all-reduce per dtype; parameters without a gradient (the same on
        every rank) are left alone."""
        grads = [p.grad for p in params if p.grad is not None]

        def reduce(flat):
            self._all_reduce(flat, None)
            flat.div_(self.world)

        with torch.no_grad():
            self._coalesced(grads, reduce)

    def broadcast(self, tensors: Iterable[torch.Tensor]) -> None:
        """Rank 0's values of `tensors` on every rank, in place."""
        def bcast(flat):
            buf = flat if self.device is None else flat.to(self.device)
            dist.broadcast(buf, src=0)
            if buf is not flat:
                flat.copy_(buf)

        with torch.no_grad():
            self._coalesced([t.detach() for t in tensors], bcast)

    def barrier(self) -> None:
        dist.barrier()


def make_mesh(data: Optional[int] = None, event: int = 1) -> Mesh:
    """The (data, event) mesh of the initialized process group; `data`
    defaults to world // event.

    Every rank of the world calls it (the groups are made collectively).
    Raises unless data x event is the world size: JAX leaves the extra
    devices of a larger world idle, here a rank without work is an error.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group "
                           "(parallel.initialize_distributed)")
    world = dist.get_world_size()
    if data is None:
        data = world // event
    if data < 1 or event < 1 or data * event != world:
        raise ValueError(f"mesh ({data}, {event}) does not cover the "
                         f"world of {world} ranks")
    rank = dist.get_rank()
    data_group = event_group = None
    # new_group is collective: every rank makes every group, in one order.
    for e in range(event):
        g = dist.new_group([d * event + e for d in range(data)])
        if rank % event == e:
            data_group = g
    for d in range(data):
        g = dist.new_group([d * event + e for e in range(event)])
        if rank // event == d:
            event_group = g
    return Mesh(data, event, rank, data_group, event_group,
                backend=dist.get_backend())


def replicate(mesh: Mesh, state: Any) -> Any:
    """Rank 0's parameters, buffers and optimizer state tensors on every
    rank (a TrainState or RAFTTrainState: its .model and .optimizer), in
    place; returns the state."""
    tensors = list(state.model.parameters()) + list(state.model.buffers())
    for slot in state.optimizer.state.values():
        tensors += [v for v in slot.values() if torch.is_tensor(v)]
    mesh.broadcast(tensors)
    return state


def _rows(mesh: Mesh, val):
    if isinstance(val, (list, tuple)):
        return type(val)(_rows(mesh, v) for v in val)
    if hasattr(val, "shape") and len(val.shape) >= 1 \
            and getattr(val, "dtype", None) is not None \
            and getattr(val.dtype, "kind", "f") not in "USO":
        return val[process_batch_slice(val.shape[0], mesh)]
    return val


def shard_batch(mesh: Mesh, batch: Dict[str, Any], num_pos_events: int = -1
                ) -> Dict[str, Any]:
    """A global batch (numpy arrays or tensors) -> this rank's share: the
    data rank's rows of every array (lists of arrays element by element),
    then the event shard of its events
    (`distributed.event_shard_batch`).  Scalars stay."""
    local = {k: _rows(mesh, v) for k, v in batch.items()}
    return event_shard_batch(mesh, local, num_pos_events)


@contextlib.contextmanager
def sync_batch_norm(model: torch.nn.Module, mesh: Optional[Mesh]):
    """Inside, `model`'s BatchNorm layers in train mode take their batch
    statistics over the data axis (the global batch); without a mesh,
    nothing changes."""
    if mesh is None:
        yield
        return
    norms = [m for m in model.modules() if isinstance(m, FlaxBatchNorm2d)]
    for m in norms:
        m.stats_sum = mesh.data_sum
    try:
        yield
    finally:
        for m in norms:
            m.stats_sum = None


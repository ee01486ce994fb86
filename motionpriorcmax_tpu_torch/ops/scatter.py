"""1-D scatter-add, deterministic or direct (JAX: ops/scatter.py).

Plain PyTorch: the JAX module is no Pallas kernel.  `scatter_add_1d` keeps
its contract, the same bits in two calls on the same inputs: the (index,
value) pairs are sorted by index (a stable sort, so equal indices keep
their input order), each run of equal indices is summed in that order
(`torch.segment_reduce`, one sequential sum per run) and the run sums are
written once each.  No atomics, so the order of the adds does not depend
on the device's scheduling.  Its backward is the gather g[idx].
`scatter_add_direct` is the plain `index_add_` (atomics on a card).
"""

from __future__ import annotations

import torch


def _scatter_add_sorted(flat_size: int, idx: torch.Tensor,
                        vals: torch.Tensor) -> torch.Tensor:
    keep = (idx >= 0) & (idx < flat_size)
    key, vals = idx[keep].long(), vals[keep].to(torch.float32)
    key_s, order = torch.sort(key, stable=True)
    runs, counts = torch.unique_consecutive(key_s, return_counts=True)
    out = torch.zeros(flat_size, dtype=torch.float32, device=vals.device)
    if runs.numel():
        out[runs] = torch.segment_reduce(vals[order], "sum", lengths=counts)
    return out


class _ScatterAdd1d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat_size, idx, vals):
        ctx.flat_size = flat_size
        ctx.save_for_backward(idx)
        return _scatter_add_sorted(flat_size, idx, vals)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        keep = (idx >= 0) & (idx < ctx.flat_size)
        gv = torch.where(keep, g[torch.where(keep, idx, 0).long()],
                         torch.zeros((), dtype=g.dtype, device=g.device))
        return None, None, gv


def scatter_add_1d(flat_size: int, idx: torch.Tensor, vals: torch.Tensor
                   ) -> torch.Tensor:
    """out[j] = sum over i with idx[i] == j of vals[i], f32 [flat_size].

    idx: [M] integer, entries outside [0, flat_size) dropped.
    vals: [M] float.  The gradient with respect to vals is g[idx] (0 for
    the dropped entries); idx has none.
    """
    return _ScatterAdd1d.apply(flat_size, idx, vals)


def scatter_add_direct(flat_size: int, idx: torch.Tensor, vals: torch.Tensor
                       ) -> torch.Tensor:
    """The plain scatter-add, `index_add_` in one call (the baseline path);
    entries outside [0, flat_size) add nothing."""
    keep = ((idx >= 0) & (idx < flat_size)).to(torch.float32)
    safe = idx.clamp(0, flat_size - 1).long()
    out = torch.zeros(flat_size, dtype=torch.float32, device=vals.device)
    return out.index_add(0, safe, vals.to(torch.float32) * keep)

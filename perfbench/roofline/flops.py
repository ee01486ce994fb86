"""Model FLOPs of a step or a request, counted once per run by
`torch.utils.flop_counter.FlopCounterMode` on the benchmark's reference
model at the cell's shapes, on the 'meta' device (no memory, no time).

A training step counts the model's forward and backward (the gradients of
the parameters, not of the input); a request the forward.  The loss, the
KNN and the interpolation are not model FLOPs.  So the count is the same
work whatever implements the model.
"""

from __future__ import annotations

import copy

import torch
from torch.utils.flop_counter import FlopCounterMode


def count(model: torch.nn.Module, inputs: torch.Tensor, backward: bool,
          forward=None) -> int:
    """FLOPs of `forward(model, inputs)` (default: model(inputs)), and with
    `backward` of the parameters' gradients of the sum of its outputs."""
    meta = copy.deepcopy(model).to("meta")
    x = torch.empty(inputs.shape, dtype=inputs.dtype, device="meta")
    call = forward or (lambda mod, t: mod(t))
    with FlopCounterMode(display=False) as counter:
        out = call(meta, x)
        if backward:
            leaves = out if isinstance(out, (list, tuple)) else [out]
            total = sum(t.float().sum() for t in leaves)
            torch.autograd.grad(total, [p for p in meta.parameters()
                                        if p.requires_grad],
                                allow_unused=True)
    return int(counter.get_total_flops())

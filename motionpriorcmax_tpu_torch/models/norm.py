"""Normalization layers with flax's arithmetic under torch's names, shared
by the UNet and the RAFT-Spline encoders.

torch's own nn.BatchNorm2d updates `running_var` with the unbiased batch
variance; flax (momentum 0.9 there, 0.1 here) uses the biased
E[x^2] - E[x]^2 for normalization and statistics alike.  torch's
nn.InstanceNorm2d takes the variance as E[(x - mean)^2]; flax's GroupNorm
with one channel per group as E[x^2] - E[x]^2.  The two differ by ~1e-5 on
unit outputs, and by ~1e-3 of the feature encoder's gradients once a
training step backpropagates through them.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.cuda.flax_batch_norm import flax_batch_norm


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d's parameters and state-dict names with flax's math.

    Train mode: mean = E[x], var = max(0, E[x^2] - E[x]^2) over (N, H, W) in
    f32; running = (1 - momentum) * running + momentum * batch statistic,
    biased variance included.  Eval mode uses the running statistics.
    y = (x - mean) * (rsqrt(var + eps) * weight) + bias in f32, cast back
    to the input's dtype, then ReLU where `relu` (the caller's ReLU fused).
    The arithmetic and its closed-form backward are
    ops/cuda/flax_batch_norm.py's: CUDA kernels on the card, their plain
    versions on the CPU.

    `stats_sum` (set by parallel.sync_batch_norm, None otherwise) sums a
    tensor over the ranks that share the batch: the train-mode statistics
    are then those of the global batch, from the group sums of sum(x),
    sum(x^2) and the element count, and the backward's sums are summed
    over the group likewise.
    """

    def __init__(self, num_features: int, relu: bool = False):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.relu = relu
        self.stats_sum = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            self.num_batches_tracked.add_(1)
        return flax_batch_norm(x, self.weight, self.bias, self.running_mean,
                               self.running_var, self.training, self.momentum,
                               self.eps, self.stats_sum, self.relu)


class FlaxInstanceNorm2d(nn.Module):
    """Non-affine instance norm (no parameters or buffers, as torch's
    nn.InstanceNorm2d(affine=False)) with flax's arithmetic: per sample and
    channel mean = E[x], var = max(0, E[x^2] - E[x]^2) over (H, W) in f32,
    y = (x - mean) * rsqrt(var + eps), cast back to the input's dtype."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=(2, 3), keepdim=True)
                          - mean * mean, min=0.0)
        return ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)

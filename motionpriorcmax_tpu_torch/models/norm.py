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


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d's parameters and state-dict names with flax's math.

    Train mode: mean = E[x], var = max(0, E[x^2] - E[x]^2) over (N, H, W) in
    f32; running = (1 - momentum) * running + momentum * batch statistic,
    biased variance included.  Eval mode uses the running statistics.
    y = (x - mean) * (rsqrt(var + eps) * weight) + bias in f32, cast back
    to the input's dtype.
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(1.0 - self.momentum).add_(
                    self.momentum * mean)
                self.running_var.mul_(1.0 - self.momentum).add_(
                    self.momentum * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[None, :, None, None]) * mul[None, :, None, None] \
            + self.bias[None, :, None, None]
        return y.to(x.dtype)


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

"""BasicEncoder: 6-residual-block feature / context encoder at 1/8 resolution
(JAX: models/raft_spline/extractor.py).

RAFT's BasicEncoder with its canonical state-dict names: conv7x7/2 (`conv1`)
-> `norm1` -> 2 residual blocks @64 (`layer1`) -> 2 @96 /2 (`layer2`) -> 2
@128 /2 (`layer3`) -> 1x1 conv to output_dim (`conv2`).  Both norms have
flax's arithmetic (models/norm.py): instance norm is non-affine; batch norm
uses batch statistics in train mode, running statistics in eval mode.

`dtype` is the compute dtype, as the JAX module's: the input is cast to it
and every convolution, the final 1x1 included, runs in it with its f32
weights and bias cast per call; the norms keep f32 statistics and return
the compute dtype.  The output is in the compute dtype.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import torch
from torch import nn
from torch.nn import functional as F

from ..norm import FlaxBatchNorm2d, FlaxInstanceNorm2d
from ..unet import CastConv2d


def _norm(norm_fn: str, planes: int) -> nn.Module:
    if norm_fn == "instance":
        return FlaxInstanceNorm2d(eps=1e-5)
    if norm_fn == "batch":
        return FlaxBatchNorm2d(planes)
    if norm_fn == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm_fn {norm_fn!r}")


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str,
                 stride: int = 1):
        super().__init__()
        self.conv1 = CastConv2d(in_planes, planes, 3, stride=stride,
                                padding=1)
        self.conv2 = CastConv2d(planes, planes, 3, padding=1)
        self.norm1 = _norm(norm_fn, planes)
        self.norm2 = _norm(norm_fn, planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            # norm3 is registered twice (as RAFT does): as `norm3` and as
            # `downsample.1`, so a checkpoint may carry either name.
            self.norm3 = _norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                CastConv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x in the compute dtype -> the same dtype."""
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, input_dim: int, output_dim: int = 256,
                 norm_fn: str = "instance",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = CastConv2d(input_dim, 64, 7, stride=2, padding=3)
        self.norm1 = _norm(norm_fn, 64)
        layers = []
        in_planes = 64
        for planes, stride in ((64, 1), (96, 2), (128, 2)):
            layers.append(nn.Sequential(
                ResidualBlock(in_planes, planes, norm_fn, stride),
                ResidualBlock(planes, planes, norm_fn, 1)))
            in_planes = planes
        self.layer1, self.layer2, self.layer3 = layers
        self.conv2 = CastConv2d(128, output_dim, 1)

    def forward(self, inputs: Union[torch.Tensor, Sequence[torch.Tensor]]
                ) -> Union[torch.Tensor, List[torch.Tensor]]:
        """NCHW input(s) -> NCHW fmap(s) at 1/8 resolution, in the compute
        dtype.

        A list input is concatenated along the batch and split back, so all
        entries share one batch-norm batch.
        """
        is_list = isinstance(inputs, (list, tuple))
        x = torch.cat(list(inputs), dim=0) if is_list else inputs
        x = F.relu(self.norm1(self.conv1(x.to(self.dtype))))
        x = self.layer3(self.layer2(self.layer1(x)))
        x = self.conv2(x)
        if is_list:
            return list(torch.split(x, [t.shape[0] for t in inputs], dim=0))
        return x

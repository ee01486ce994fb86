"""UNet from event voxel grids to motion-basis coefficient grids
(JAX: models/unet.py), NCHW.

  DoubleConv = (conv3x3 no bias -> BatchNorm -> ReLU) x 2
  4 x Down   = maxpool 2 -> DoubleConv        (64 -> 128 -> 256 -> 512 -> 1024)
  4 x Up     = ConvTranspose2d(k2, s2) -> pad to the skip -> concat -> DoubleConv
  OutConv    = conv1x1

The modules carry the reference's state-dict names (`inc.double_conv.0`,
`down{i}.maxpool_conv.1.double_conv...`, `up{i}.up`, `up{i}.conv...`,
`outc.conv`), so JAX `training/checkpoint.py::torch_unet_to_flax` reads the
port's weights and `training/checkpoint.py::flax_unet_to_torch` writes JAX
weights into the port.

BatchNorm follows flax, not torch: the batch variance is E[x^2] - E[x]^2
(biased) in both normalization and the running statistics, and the running
statistics move by momentum 0.1 (flax momentum 0.9); torch's own
BatchNorm would keep the unbiased variance.  compute_dtype 'bfloat16' mirrors
the JAX module's casts: bf16 convolutions, statistics and normalization in
f32 with the result cast to bf16, f32 parameters and statistics, the 1x1
output convolution in f32.  'float32' runs with TF32 off.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..device import no_tf32
from .norm import FlaxBatchNorm2d

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _Conv(nn.Conv2d):
    """Conv2d that runs in the input's dtype (weights cast per call)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding)


class _ConvTranspose(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype), stride=2)


class DoubleConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: int = None):
        super().__init__()
        mid = mid_channels or out_channels
        self.double_conv = nn.Sequential(
            _Conv(in_channels, mid, 3, padding=1, bias=False),
            FlaxBatchNorm2d(mid), nn.ReLU(),
            _Conv(mid, out_channels, 3, padding=1, bias=False),
            FlaxBatchNorm2d(out_channels), nn.ReLU())

    def forward(self, x):
        return self.double_conv(x)


class Down(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2),
                                          DoubleConv(in_channels, out_channels))

    def forward(self, x):
        return self.maxpool_conv(x)


class Up(nn.Module):
    """Upsample to in // 2 channels, concat after the skip's channels."""

    def __init__(self, in_channels: int, skip_channels: int,
                 out_channels: int):
        super().__init__()
        self.up = _ConvTranspose(in_channels, in_channels // 2, kernel_size=2,
                                 stride=2)
        self.conv = DoubleConv(skip_channels + in_channels // 2, out_channels)

    def forward(self, x1, x2):
        x1 = self.up(x1)
        dh = x2.shape[2] - x1.shape[2]
        dw = x2.shape[3] - x1.shape[3]
        x1 = F.pad(x1, [dw // 2, dw - dw // 2, dh // 2, dh - dh // 2])
        return self.conv(torch.cat([x2, x1.to(x2.dtype)], dim=1))


class OutConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size=1)

    def forward(self, x):
        return self.conv(x)


class UNet(nn.Module):
    """NCHW voxel grid [B, n_channels, H, W] -> [B, n_classes, H, W] f32."""

    def __init__(self, n_channels: int, n_classes: int,
                 widths: Sequence[int] = (64, 128, 256, 512, 1024),
                 compute_dtype: str = "float32"):
        super().__init__()
        if compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute_dtype {compute_dtype!r}; "
                             f"expected one of {tuple(_DTYPES)}")
        self.dtype = _DTYPES[compute_dtype]
        w = tuple(widths)
        self.inc = DoubleConv(n_channels, w[0])
        self.down1 = Down(w[0], w[1])
        self.down2 = Down(w[1], w[2])
        self.down3 = Down(w[2], w[3])
        self.down4 = Down(w[3], w[4])
        self.up1 = Up(w[4], w[3], w[3])
        self.up2 = Up(w[3], w[2], w[2])
        self.up3 = Up(w[2], w[1], w[1])
        self.up4 = Up(w[1], w[0], w[0])
        self.outc = OutConv(w[0], n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            x = x.to(self.dtype)
            x1 = self.inc(x)
            x2 = self.down1(x1)
            x3 = self.down2(x2)
            x4 = self.down3(x3)
            x5 = self.down4(x4)
            y = self.up1(x5, x4)
            y = self.up2(y, x3)
            y = self.up3(y, x2)
            y = self.up4(y, x1)
            return self.outc(y.float())

"""BasicUpdateBlock: motion encoder + SepConvGRU + delta-curve and mask heads
(JAX: models/raft_spline/update.py).

Canonical RAFT state-dict names (`encoder.convc1` ... `gru.convq2`,
`flow_head.conv1/2`, `mask.0/2`).  The flow channel count generalizes from
RAFT's 2 to the curve parameter dim 2*degree; the motion feature keeps
motion_dim channels by reserving param_dim of them for the raw params.

`dtype` is the compute dtype, as the JAX module's (f32 weights cast per
call): the motion encoder, the GRU's convolutions and the heads' hidden
convolutions run in it; the GRU's gate combine and its state `net`, the
delta head's output convolution and the mask head's 1x1 run in f32, since
the curve parameters and the upsample weights accumulate over the
iterations.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..unet import CastConv2d


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_channels: int, param_dim: int,
                 motion_dim: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.convc1 = CastConv2d(corr_channels, 256, 1)
        self.convc2 = CastConv2d(256, 192, 3, padding=1)
        self.convf1 = CastConv2d(param_dim, 128, 7, padding=3)
        self.convf2 = CastConv2d(128, 64, 3, padding=1)
        self.conv = CastConv2d(192 + 64, motion_dim - param_dim, 3, padding=1)

    def forward(self, params: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        """f32 params and corr -> the motion feature in the compute dtype,
        the raw params cast to it in its last param_dim channels."""
        dt = self.dtype
        cor = F.relu(self.convc2(F.relu(self.convc1(corr.to(dt)))))
        flo = F.relu(self.convf2(F.relu(self.convf1(params.to(dt)))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, params.to(dt)], dim=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim: int = 128, input_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        c = hidden_dim + input_dim
        self.convz1 = CastConv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convr1 = CastConv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convq1 = CastConv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convz2 = CastConv2d(c, hidden_dim, (5, 1), padding=(2, 0))
        self.convr2 = CastConv2d(c, hidden_dim, (5, 1), padding=(2, 0))
        self.convq2 = CastConv2d(c, hidden_dim, (5, 1), padding=(2, 0))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """f32 state h, input x -> the new state in f32: gates and the
        candidate in the compute dtype, their combine in f32."""
        dt = self.dtype
        x = x.to(dt)
        for convz, convr, convq in ((self.convz1, self.convr1, self.convq1),
                                    (self.convz2, self.convr2, self.convq2)):
            hx = torch.cat([h.to(dt), x], dim=1)
            z = torch.sigmoid(convz(hx))
            r = torch.sigmoid(convr(hx))
            q = torch.tanh(convq(torch.cat([r * h.to(dt), x], dim=1)))
            z = z.float()
            h = (1.0 - z) * h + z * q.float()
        return h


class DeltaHead(nn.Module):
    def __init__(self, input_dim: int, out_dim: int, hidden: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = CastConv2d(input_dim, hidden, 3, padding=1)
        self.conv2 = CastConv2d(hidden, out_dim, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The hidden conv in the compute dtype, the output conv in f32."""
        return self.conv2(F.relu(self.conv1(x.to(self.dtype))).float())


class BasicUpdateBlock(nn.Module):
    def __init__(self, corr_channels: int, param_dim: int,
                 hidden_dim: int = 128, context_dim: int = 128,
                 motion_dim: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder = BasicMotionEncoder(corr_channels, param_dim, motion_dim,
                                          dtype)
        self.gru = SepConvGRU(hidden_dim, context_dim + motion_dim, dtype)
        self.flow_head = DeltaHead(hidden_dim, param_dim, dtype=dtype)
        # Called layer by layer (two dtypes); a Sequential for its names.
        self.mask = nn.Sequential(CastConv2d(hidden_dim, 256, 3, padding=1),
                                  nn.ReLU(inplace=True),
                                  CastConv2d(256, 64 * 9, 1))

    def forward(self, net: torch.Tensor, inp: torch.Tensor, corr: torch.Tensor,
                params: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """f32 net, inp, corr and params -> (net', up_mask [B, 64*9, H, W],
        delta_params), all f32."""
        motion = self.encoder(params, corr)
        net = self.gru(net, torch.cat([inp.to(motion.dtype), motion], dim=1))
        delta = self.flow_head(net)
        # The 3x3 in the compute dtype, the 1x1 in f32; 0.25 scales the mask
        # to balance gradients (RAFT convention).
        hidden = F.relu(self.mask[0](net.to(self.dtype)))
        mask = 0.25 * self.mask[2](hidden.float())
        return net, mask, delta

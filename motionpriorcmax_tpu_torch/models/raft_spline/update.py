"""BasicUpdateBlock: motion encoder + SepConvGRU + delta-curve and mask heads
(JAX: models/raft_spline/update.py).

Canonical RAFT state-dict names (`encoder.convc1` ... `gru.convq2`,
`flow_head.conv1/2`, `mask.0/2`).  The flow channel count generalizes from
RAFT's 2 to the curve parameter dim 2*degree; the motion feature keeps
motion_dim channels by reserving param_dim of them for the raw params.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_channels: int, param_dim: int,
                 motion_dim: int = 128):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_channels, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(param_dim, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(192 + 64, motion_dim - param_dim, 3, padding=1)

    def forward(self, params: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(params))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, params], dim=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim: int = 128, input_dim: int = 256):
        super().__init__()
        c = hidden_dim + input_dim
        self.convz1 = nn.Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convr1 = nn.Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convq1 = nn.Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convz2 = nn.Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))
        self.convr2 = nn.Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))
        self.convq2 = nn.Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for convz, convr, convq in ((self.convz1, self.convr1, self.convq1),
                                    (self.convz2, self.convr2, self.convq2)):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(convz(hx))
            r = torch.sigmoid(convr(hx))
            q = torch.tanh(convq(torch.cat([r * h, x], dim=1)))
            h = (1.0 - z) * h + z * q
        return h


class DeltaHead(nn.Module):
    def __init__(self, input_dim: int, out_dim: int, hidden: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, out_dim, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    def __init__(self, corr_channels: int, param_dim: int,
                 hidden_dim: int = 128, context_dim: int = 128,
                 motion_dim: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_channels, param_dim, motion_dim)
        self.gru = SepConvGRU(hidden_dim, context_dim + motion_dim)
        self.flow_head = DeltaHead(hidden_dim, param_dim)
        self.mask = nn.Sequential(nn.Conv2d(hidden_dim, 256, 3, padding=1),
                                  nn.ReLU(inplace=True),
                                  nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net: torch.Tensor, inp: torch.Tensor, corr: torch.Tensor,
                params: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (net', up_mask [B, 64*9, H, W], delta_params)."""
        motion = self.encoder(params, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        delta = self.flow_head(net)
        # 0.25 scales the mask to balance gradients (RAFT convention).
        mask = 0.25 * self.mask(net)
        return net, mask, delta

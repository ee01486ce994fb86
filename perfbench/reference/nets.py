"""The two networks in plain PyTorch, under the port's state-dict names.

UNet (MotionPriorCMax's flow network): DoubleConv = (conv3x3 without bias
-> BatchNorm -> ReLU) x 2; four Down = maxpool 2 -> DoubleConv; four Up =
ConvTranspose2d(k2, s2) -> pad to the skip -> concat -> DoubleConv; a 1x1
output conv.  BatchNorm has flax's arithmetic (biased E[x^2] - E[x]^2 in
both the normalization and the running statistics, momentum 0.1), as the
reference JAX model trains it.

RAFT-Spline (f32): two BasicEncoders (feature: instance norm, context:
batch norm), all-pairs correlation volumes against five targets, a
per-target pyramid, a (2r+1)^2 bilinear window lookup per level, the
SepConvGRU update block and convex upsampling of the Bezier parameters.

Precision is a property of the model object, so the control of the
benchmark's comparison is this same code one precision step down:
  UNet       'bfloat16' (the configuration's bf16 convolutions, f32
             parameters, statistics and loss) or 'fp8' (each convolution's
             input and weight rounded to float8_e4m3fn with a per-tensor
             scale, then the bf16 convolution);
  RAFT       'float32' (TF32 off) or 'tf32' (TF32 on for cuDNN and cuBLAS).
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

FP8_MAX = 448.0     # largest finite float8_e4m3fn


@contextlib.contextmanager
def matmul_precision(precision: str):
    """'float32': TF32 off for cuBLAS and cuDNN; 'tf32': on.  The
    caller's flags are restored after."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"unknown f32 precision {precision!r}")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8_e4m3fn with a per-tensor scale (amax -> 448),
    returned in x's dtype; the gradient passes straight through."""
    scale = x.detach().abs().amax().float().clamp(min=1e-12) / FP8_MAX
    q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


# -- UNet -------------------------------------------------------------------

class FlaxBatchNorm2d(nn.BatchNorm2d):
    """Train mode: batch mean and biased variance E[x^2] - E[x]^2 in f32,
    running statistics moved by momentum 0.1 with the same variance; eval
    mode: the running statistics.  Output cast to the input's dtype."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = ((xf - mean[None, :, None, None]) * mul[None, :, None, None]
             + self.bias[None, :, None, None])
        return y.to(x.dtype)


class LowConv2d(nn.Conv2d):
    """A convolution in the model's low precision: the f32 weight cast to
    the input's dtype per call (rounded to fp8 first under 'fp8')."""

    precision = "bfloat16"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        if self.precision == "fp8":
            x, w = fp8_round(x), fp8_round(w)
        return F.conv2d(x, w, None, self.stride, self.padding)


class LowConvTranspose2d(nn.ConvTranspose2d):
    precision = "bfloat16"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        if self.precision == "fp8":
            x, w = fp8_round(x), fp8_round(w)
        return F.conv_transpose2d(x, w, self.bias.to(x.dtype), stride=2)


class DoubleConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.double_conv = nn.Sequential(
            LowConv2d(cin, cout, 3, padding=1, bias=False),
            FlaxBatchNorm2d(cout), nn.ReLU(),
            LowConv2d(cout, cout, 3, padding=1, bias=False),
            FlaxBatchNorm2d(cout), nn.ReLU())

    def forward(self, x):
        return self.double_conv(x)


class Down(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2),
                                          DoubleConv(cin, cout))

    def forward(self, x):
        return self.maxpool_conv(x)


class Up(nn.Module):
    def __init__(self, cin: int, cskip: int, cout: int):
        super().__init__()
        self.up = LowConvTranspose2d(cin, cin // 2, kernel_size=2, stride=2)
        self.conv = DoubleConv(cskip + cin // 2, cout)

    def forward(self, x1, x2):
        x1 = self.up(x1)
        dh = x2.shape[2] - x1.shape[2]
        dw = x2.shape[3] - x1.shape[3]
        x1 = F.pad(x1, [dw // 2, dw - dw // 2, dh // 2, dh - dh // 2])
        return self.conv(torch.cat([x2, x1.to(x2.dtype)], dim=1))


class OutConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size=1)

    def forward(self, x):
        return self.conv(x)


class UNet(nn.Module):
    """[B, nbins, H, W] voxel grid -> [B, 2K, H, W] f32 coefficients; the
    convolutions in bf16 (or fp8, see the module docstring), the 1x1
    output convolution in f32."""

    def __init__(self, n_channels: int, n_classes: int,
                 widths: Sequence[int] = (64, 128, 256, 512, 1024),
                 precision: str = "bfloat16"):
        super().__init__()
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
        self.set_precision(precision)

    def set_precision(self, precision: str) -> None:
        if precision not in ("bfloat16", "fp8"):
            raise ValueError(f"unknown UNet precision {precision!r}")
        for mod in self.modules():
            if isinstance(mod, (LowConv2d, LowConvTranspose2d)):
                mod.precision = precision

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with matmul_precision("float32"):
            x1 = self.inc(x.to(torch.bfloat16))
            x2 = self.down1(x1)
            x3 = self.down2(x2)
            x4 = self.down3(x3)
            x5 = self.down4(x4)
            y = self.up1(x5, x4)
            y = self.up2(y, x3)
            y = self.up3(y, x2)
            y = self.up4(y, x1)
            return self.outc(y.float())


# -- RAFT-Spline --------------------------------------------------------------

class InstanceNorm(nn.Module):
    """Non-affine instance norm, variance E[x^2] - E[x]^2 (flax's)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = torch.clamp((x * x).mean(dim=(2, 3), keepdim=True) - mean * mean,
                          min=0.0)
        return (x - mean) * torch.rsqrt(var + 1e-5)


def _norm(kind: str, planes: int) -> nn.Module:
    return InstanceNorm() if kind == "instance" else FlaxBatchNorm2d(planes)


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, planes: int, norm: str, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1 = _norm(norm, planes)
        self.norm2 = _norm(norm, planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.norm3 = _norm(norm, planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, planes, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, cin: int, cout: int, norm: str):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, 64, 7, stride=2, padding=3)
        self.norm1 = _norm(norm, 64)
        layers, planes_in = [], 64
        for planes, stride in ((64, 1), (96, 2), (128, 2)):
            layers.append(nn.Sequential(
                ResidualBlock(planes_in, planes, norm, stride),
                ResidualBlock(planes, planes, norm, 1)))
            planes_in = planes
        self.layer1, self.layer2, self.layer3 = layers
        self.conv2 = nn.Conv2d(128, cout, 1)

    def forward(self, inputs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Inputs concatenated along the batch (one BatchNorm batch)."""
        x = torch.cat(list(inputs), dim=0)
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.conv2(self.layer3(self.layer2(self.layer1(x))))
        return list(torch.split(x, [t.shape[0] for t in inputs], dim=0))


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_channels: int, param_dim: int, motion_dim: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_channels, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(param_dim, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(192 + 64, motion_dim - param_dim, 3, padding=1)

    def forward(self, params, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(params))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, params], dim=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden: int, cin: int):
        super().__init__()
        c = hidden + cin
        self.convz1 = nn.Conv2d(c, hidden, (1, 5), padding=(0, 2))
        self.convr1 = nn.Conv2d(c, hidden, (1, 5), padding=(0, 2))
        self.convq1 = nn.Conv2d(c, hidden, (1, 5), padding=(0, 2))
        self.convz2 = nn.Conv2d(c, hidden, (5, 1), padding=(2, 0))
        self.convr2 = nn.Conv2d(c, hidden, (5, 1), padding=(2, 0))
        self.convq2 = nn.Conv2d(c, hidden, (5, 1), padding=(2, 0))

    def forward(self, h, x):
        for cz, cr, cq in ((self.convz1, self.convr1, self.convq1),
                           (self.convz2, self.convr2, self.convq2)):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(cz(hx))
            r = torch.sigmoid(cr(hx))
            q = torch.tanh(cq(torch.cat([r * h, x], dim=1)))
            h = (1.0 - z) * h + z * q
        return h


class DeltaHead(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, 256, 3, padding=1)
        self.conv2 = nn.Conv2d(256, cout, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    def __init__(self, corr_channels: int, param_dim: int, hidden: int,
                 context: int, motion: int):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_channels, param_dim, motion)
        self.gru = SepConvGRU(hidden, context + motion)
        self.flow_head = DeltaHead(hidden, param_dim)
        self.mask = nn.Sequential(nn.Conv2d(hidden, 256, 3, padding=1),
                                  nn.ReLU(inplace=True),
                                  nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, params):
        motion = self.encoder(params, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        delta = self.flow_head(net)
        return net, 0.25 * self.mask(net), delta


def bernstein(times: torch.Tensor, degree: int) -> torch.Tensor:
    """[T] -> [T, degree] Bernstein basis without P0 (P0 == 0)."""
    i = torch.arange(1, degree + 1, dtype=times.dtype, device=times.device)
    binom = torch.tensor([float(math.comb(degree, k))
                          for k in range(1, degree + 1)],
                         dtype=times.dtype, device=times.device)
    t = times[:, None]
    return binom[None] * (1.0 - t) ** (degree - i)[None] * t ** i[None]


def curve_flow(params: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """Bezier parameters [B, 2 deg, H, W] -> flow [T, B, 2, H, W] (x, y)."""
    b, c, h, w = params.shape
    basis = bernstein(times.to(params.device, params.dtype), c // 2)
    return torch.einsum("bdphw,tp->tbdhw", params.reshape(b, 2, c // 2, h, w),
                        basis)


def cvx_upsample(data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """RAFT's convex 8x upsampling of [N, C, H, W] (scaled by 8)."""
    n, c, h, w = data.shape
    mask = torch.softmax(mask.reshape(n, 1, 9, 8, 8, h, w), dim=2)
    patches = F.unfold(8.0 * data, (3, 3), padding=1).reshape(n, c, 9, 1, 1,
                                                              h, w)
    up = torch.sum(mask * patches, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(n, c, 8 * h, 8 * w)


def window_lookup(corr: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                  radius: int) -> torch.Tensor:
    """corr [N, H2, W2] sampled around (cx, cy) [N]: [N, (2r+1)^2]
    bilinear window features, row-major over (dy, dx), zero outside."""
    n, h2, w2 = corr.shape
    win = 2 * radius + 2
    x0, y0 = torch.floor(cx), torch.floor(cy)
    fx = (cx - x0)[:, None, None]
    fy = (cy - y0)[:, None, None]
    x0 = x0.clamp(-radius - 2, w2 + radius).long() - radius
    y0 = y0.clamp(-radius - 2, h2 + radius).long() - radius
    offs = torch.arange(win, device=corr.device)
    rows = y0[:, None] + offs[None]
    cols = x0[:, None] + offs[None]
    ok = (((rows >= 0) & (rows < h2))[:, :, None]
          & ((cols >= 0) & (cols < w2))[:, None, :])
    idx = (rows.clamp(0, h2 - 1)[:, :, None] * w2
           + cols.clamp(0, w2 - 1)[:, None, :]).reshape(n, win * win)
    vals = torch.gather(corr.reshape(n, h2 * w2), 1, idx).reshape(n, win, win)
    vals = torch.where(ok, vals, torch.zeros((), device=corr.device))
    feat = ((1 - fy) * ((1 - fx) * vals[:, :-1, :-1] + fx * vals[:, :-1, 1:])
            + fy * ((1 - fx) * vals[:, 1:, :-1] + fx * vals[:, 1:, 1:]))
    return feat.reshape(n, (2 * radius + 1) ** 2)


class RAFTSpline(nn.Module):
    """Tab2L5's RAFT-Spline over event voxel grids only (no images)."""

    def __init__(self, nbins_context: int = 41, nbins_correlation: int = 25,
                 degree: int = 10, target_indices=(8, 16, 24, 32, 40),
                 levels=(1, 1, 1, 1, 4), radius: int = 4, hidden: int = 128,
                 context: int = 128, feature: int = 256, motion: int = 128,
                 iters: int = 12, precision: str = "float32"):
        super().__init__()
        self.nbins_context, self.nbins_corr = nbins_context, nbins_correlation
        self.degree, self.targets = degree, tuple(target_indices)
        self.levels, self.radius = tuple(levels), radius
        self.hidden, self.iters, self.precision = hidden, iters, precision
        corr_channels = sum(levels) * (2 * radius + 1) ** 2
        self.fnet_ev = BasicEncoder(nbins_correlation, feature, "instance")
        self.cnet = BasicEncoder(nbins_context, hidden + context, "batch")
        self.update_block = BasicUpdateBlock(corr_channels, 2 * degree, hidden,
                                             context, motion)

    def _pyramid(self, corr: torch.Tensor):
        pyr = [(tuple(range(len(self.levels))), corr)]
        for lvl in range(2, max(self.levels) + 1):
            keep = tuple(i for i, v in enumerate(self.levels) if v >= lvl)
            prev_idx, prev = pyr[-1]
            sel = torch.stack([prev[prev_idx.index(i)] for i in keep])
            h, w = sel.shape[-2:]
            pyr.append((keep, sel.reshape(*sel.shape[:-2], h // 2, 2, w // 2,
                                          2).mean(dim=(-3, -1))))
        return pyr

    def _lookup(self, pyr, coords: torch.Tensor) -> torch.Tensor:
        """coords [T, B, 2, h, w] (x, y) -> [B, sum_l T_l (2r+1)^2, h, w]:
        level-major, then target, then the window."""
        _, b, _, h1, w1 = coords.shape
        k = (2 * self.radius + 1) ** 2
        outs = []
        for lvl, (idx, corr_l) in enumerate(pyr):
            sel = torch.stack([coords[i] for i in idx]) / (2.0 ** lvl)
            h2, w2 = corr_l.shape[-2:]
            feat = window_lookup(corr_l.reshape(-1, h2, w2),
                                 sel[:, :, 0].reshape(-1),
                                 sel[:, :, 1].reshape(-1), self.radius)
            outs.append(feat.reshape(len(idx), b, h1 * w1, k)
                        .permute(1, 0, 3, 2).reshape(b, len(idx) * k, h1, w1))
        return torch.cat(outs, dim=1)

    def forward(self, voxel: torch.Tensor, keep_all: bool = False
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Per-iteration low-resolution parameters and upsample masks (the
        last iteration's only unless keep_all)."""
        with matmul_precision(self.precision):
            grids = [voxel[:, i:i + self.nbins_corr]
                     for i in (0, *self.targets)]
            fmaps = self.fnet_ev(grids)
            f1 = fmaps[0]
            b, d, h, w = f1.shape
            f2 = torch.stack(fmaps[1:]).reshape(len(self.targets), b, d, h * w)
            f1 = f1.reshape(b, d, h * w).transpose(1, 2)[None]
            corr = (torch.matmul(f1, f2) / math.sqrt(d)).reshape(
                -1, b, h * w, h, w)
            pyr = self._pyramid(corr)
            cnet = self.cnet([voxel[:, -self.nbins_context:]])[0]
            net = torch.tanh(cnet[:, :self.hidden])
            inp = torch.relu(cnet[:, self.hidden:])
            gy, gx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=voxel.device),
                torch.arange(w, dtype=torch.float32, device=voxel.device),
                indexing="ij")
            coords0 = torch.stack([gx, gy])[None].expand(b, 2, h, w)
            params = torch.zeros(b, 2 * self.degree, h, w, device=voxel.device)
            dt = 1.0 / (self.nbins_context - 1)
            basis = bernstein(torch.tensor([dt * i for i in self.targets],
                                           device=voxel.device), self.degree)
            params_seq, mask_seq = [], []
            for _ in range(self.iters):
                pv = params.reshape(b, 2, self.degree, h, w)
                coords1 = coords0[None] + torch.einsum("bdphw,tp->tbdhw", pv,
                                                       basis)
                net, mask, delta = self.update_block(
                    net, inp, self._lookup(pyr, coords1), params)
                params = params + delta
                if not keep_all:
                    params_seq.clear()
                    mask_seq.clear()
                params_seq.append(params)
                mask_seq.append(mask)
            return params_seq, mask_seq

    def upsampled(self, voxel: torch.Tensor) -> torch.Tensor:
        """The last iteration's full-resolution parameters (test mode)."""
        params_seq, mask_seq = self(voxel)
        with matmul_precision(self.precision):
            return cvx_upsample(params_seq[-1], mask_seq[-1])

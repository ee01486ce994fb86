"""RAFT-Spline over events and the two boundary frames ("E+I"), and its
supervised training step, in plain PyTorch under the port's state-dict
names.

The model is BFlow's (Gehrig, Muglikar, Scaramuzza, "Dense Continuous-Time
Optical Flow from Event Cameras", TPAMI 2024, arXiv:2203.13674) as the
reference's `config/trajectory_inference/model/raft-spline.yaml` builds it
with images on: `RAFTSpline` of nets.py (the event encoder, five event
targets, the update block, the Bezier curves) plus
  * `fnet_img`, a BasicEncoder 3 -> feature (instance norm), over both
    frames normalized as 2 (x / 255) - 1 in one batch;
  * the frame volume, frame 0's features against frame 1's, as the last
    correlation target, looked up at t = 1 with its own pyramid depth;
  * the context encoder over cat(the voxel grid's context bins, frame 0).

The step is the MultiFlow recipe (`raft-spline_multiflow-500ms_
supervised.yaml`): per iteration i of N, RAFT's convex upsampling, the
Bezier flow at the GT timestamps, the mean L1 against the GT flow (over
the valid pixels and both channels where a validity mask is given),
weighted gamma^(N-1-i); the caller applies AdamW (optim.py).

Departures from the published description:
  * the instance and batch norms take flax's variance E[x^2] - E[x]^2,
    as nets.py does (the port's JAX model trains so);
  * the lookup radius is 4 at every level (the card's kernel is built for
    it, and every configuration uses it);
  * the reference snapshot ships no training script: the step follows the
    paper's sequence loss (gamma 0.8 over all iterations, L1 at every GT
    timestamp) as the repository's experiment file reconstructs it;
  * MultiFlow gives no validity mask, so the mean runs over every pixel.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .nets import (BasicEncoder, RAFTSpline, bernstein, curve_flow,
                   cvx_upsample, matmul_precision)
from .steps import _grads


def corr_volume(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """All pairs of f1 [B, D, h, w] against T maps f2 [T, B, D, h, w]:
    [T, B, h*w, h, w], scaled by 1/sqrt(D)."""
    b, d, h, w = f1.shape
    q = f1.reshape(b, d, h * w).transpose(1, 2)[None]
    p = f2.reshape(f2.shape[0], b, d, h * w)
    return (torch.matmul(q, p) / math.sqrt(d)).reshape(-1, b, h * w, h, w)


class RAFTSplineEI(RAFTSpline):
    """RAFT-Spline over a voxel grid and a pair of boundary frames."""

    def __init__(self, nbins_context: int = 41, nbins_correlation: int = 25,
                 degree: int = 10, target_indices=(8, 16, 24, 32, 40),
                 levels=(1, 1, 1, 1, 4), img_levels: int = 4,
                 radius: int = 4, hidden: int = 128, context: int = 128,
                 feature: int = 256, motion: int = 128, iters: int = 12,
                 precision: str = "float32"):
        # The frame target's depth joins the event targets' levels, so the
        # update block takes sum(levels) windows and the pyramid holds it.
        super().__init__(nbins_context, nbins_correlation, degree,
                         target_indices, tuple(levels) + (img_levels,),
                         radius, hidden, context, feature, motion, iters,
                         precision)
        self.fnet_img = BasicEncoder(3, feature, "instance")
        self.cnet = BasicEncoder(nbins_context + 3, hidden + context, "batch")

    def forward(self, voxel: torch.Tensor,
                images: Sequence[torch.Tensor] = (), keep_all: bool = False
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Per-iteration low-resolution parameters and upsample masks (the
        last iteration's only unless keep_all); `images` the frames
        [B, 3, H, W] at the start and end of the window, values 0..255."""
        if len(images) != 2:
            raise ValueError("RAFTSplineEI needs the pair of boundary frames")
        with matmul_precision(self.precision):
            grids = [voxel[:, i:i + self.nbins_corr]
                     for i in (0, *self.targets)]
            fmaps = self.fnet_ev(grids)
            imgs = [2.0 * (im / 255.0) - 1.0 for im in images]
            fimg = self.fnet_img(imgs)
            corr = torch.cat([corr_volume(fmaps[0], torch.stack(fmaps[1:])),
                              corr_volume(fimg[0], fimg[1][None])])
            pyr = self._pyramid(corr)
            cnet = self.cnet([torch.cat([voxel[:, -self.nbins_context:],
                                         imgs[0]], dim=1)])[0]
            net = torch.tanh(cnet[:, :self.hidden])
            inp = torch.relu(cnet[:, self.hidden:])
            b, _, h, w = fmaps[0].shape
            gy, gx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=voxel.device),
                torch.arange(w, dtype=torch.float32, device=voxel.device),
                indexing="ij")
            coords0 = torch.stack([gx, gy])[None].expand(b, 2, h, w)
            params = torch.zeros(b, 2 * self.degree, h, w, device=voxel.device)
            dt = 1.0 / (self.nbins_context - 1)
            times = [dt * i for i in self.targets] + [1.0]
            basis = bernstein(torch.tensor(times, device=voxel.device),
                              self.degree)
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


def supervised_loss(model: RAFTSpline, batch: Dict[str, torch.Tensor],
                    gamma: float) -> torch.Tensor:
    """The gamma-weighted L1 of every iteration's upsampled curves at the
    GT timestamps against the GT flow.

    batch: 'ev_repr' [B, nbins, H, W]; 'img' [B, 2, 3, H, W] for
    RAFTSplineEI (nets.RAFTSpline takes none); 'flow' [B, T, 2, H, W]
    (x, y); 'flow_timestamps' [B, T] (row 0 is used); optional
    'flow_valid' [B, T, H, W]."""
    img = batch.get("img")
    if img is None:
        params_seq, mask_seq = model(batch["ev_repr"], keep_all=True)
    else:
        params_seq, mask_seq = model(batch["ev_repr"], (img[:, 0], img[:, 1]),
                                     keep_all=True)
    gt = batch["flow"].movedim(1, 0)                         # [T, B, 2, H, W]
    ts = batch["flow_timestamps"][0]
    valid: Optional[torch.Tensor] = batch.get("flow_valid")
    n = len(params_seq)
    loss = torch.zeros((), device=gt.device)
    with matmul_precision(model.precision):
        for i, (p, m) in enumerate(zip(params_seq, mask_seq)):
            err = (curve_flow(cvx_upsample(p, m), ts) - gt).abs()
            if valid is None:
                term = err.mean()
            else:
                v = valid.movedim(1, 0)[:, :, None].float()
                term = (err * v).sum() / (2.0 * v.sum().clamp(min=1.0))
            loss = loss + gamma ** (n - 1 - i) * term
    return loss


def supervised_step(model: RAFTSpline, params: Dict[str, torch.Tensor],
                    batch: Dict[str, torch.Tensor], gamma: float = 0.8
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, gradients by name) of one supervised step, model in train
    mode; the caller applies the optimizer."""
    loss = supervised_loss(model, batch, gamma)
    return loss, _grads(loss, params)

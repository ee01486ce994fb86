"""Trilinear voxel vote of event rows: the Hopper kernel and its plain
version.

Port of the TPU kernel `motionpriorcmax_tpu/ops/pallas/voxel_vote.py::
voxel_vote_pallas_sorted`.  The port computes the exact f32 function of the
JAX scatter voxelizer (`motionpriorcmax_tpu/ops/events.py::
voxel_grid_from_events`), not the TPU kernel's bf16 tap tiles; events need
not be sorted.  Forward only: the grid is built from event data, nothing
differentiates through it.  The CUDA source is
`motionpriorcmax_tpu_torch/csrc/voxel_vote.cu`; its header gives the bound
and the design.

  voxel_vote(events, num_bins, height, width)        the launch (counted)
  voxel_vote_plain(events, num_bins, height, width)  the same in PyTorch
  voxel_taps(events, num_bins, height, width)        the 8 taps per event

On a CUDA tensor `voxel_vote` launches the kernel or raises; on a CPU
tensor it runs the plain version.  `.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch


def _check(events: torch.Tensor) -> None:
    if events.dim() != 3 or events.shape[-1] != 6:
        raise ValueError(f"events must be [B, M, 6], got {tuple(events.shape)}")
    if events.dtype != torch.float32:
        raise TypeError("events must be float32")


def voxel_taps(events: torch.Tensor, num_bins: int, height: int, width: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flat index int64 [8, B, M] into [B * nbins * H * W], value f32
    [8, B, M]) of each event's eight taps; masked taps get index 0 and
    value 0.

    t_norm = t * (nbins - 1), value (2p - 1) * valid, floor / floor + 1 taps
    with weights 1 - |tap - coordinate| per axis, each axis masked to its
    range.  Coordinates are clamped to [-3, size + 2] first, where both taps
    stay outside the range as before, so the integer cast is defined for
    any input; the kernel does the same."""
    _check(events)
    b = events.shape[0]
    value = (2.0 * events[..., 3] - 1.0) * events[..., 5]
    y = events[..., 0].clamp(-3.0, height + 2.0)
    x = events[..., 1].clamp(-3.0, width + 2.0)
    t = (events[..., 2] * (num_bins - 1)).clamp(-3.0, num_bins + 2.0)
    x0, y0, t0 = torch.floor(x), torch.floor(y), torch.floor(t)
    base = torch.arange(b, device=events.device)[:, None] * num_bins
    idx, val = [], []
    for dx in (0.0, 1.0):
        xi = x0 + dx
        wx = 1.0 - torch.abs(xi - x)
        mx = (xi >= 0) & (xi < width)
        for dy in (0.0, 1.0):
            yi = y0 + dy
            wy = 1.0 - torch.abs(yi - y)
            my = (yi >= 0) & (yi < height)
            for dt in (0.0, 1.0):
                ti = t0 + dt
                wt = 1.0 - torch.abs(ti - t)
                mask = mx & my & (ti >= 0) & (ti < num_bins)
                flat = (((base + ti.long()) * height + yi.long()) * width
                        + xi.long())
                idx.append(torch.where(mask, flat, torch.zeros_like(flat)))
                val.append(torch.where(mask, value * wx * wy * wt,
                                       torch.zeros_like(value)))
    return torch.stack(idx), torch.stack(val)


def voxel_vote_plain(events: torch.Tensor, num_bins: int, height: int,
                     width: int) -> torch.Tensor:
    """[B, M, 6] (y, x, t in [0, 1], p, bin, valid) -> [B, nbins, H, W] f32
    trilinear vote (plain)."""
    _check(events)
    idx, val = voxel_taps(events, num_bins, height, width)
    out = torch.zeros(events.shape[0] * num_bins * height * width,
                      dtype=torch.float32, device=events.device)
    out.index_add_(0, idx.reshape(-1), val.reshape(-1))
    return out.reshape(events.shape[0], num_bins, height, width)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built library's C entry point, argument types declared."""
    from .build import load_library

    fn = load_library("voxel_vote").voxel_vote
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.restype = i
    fn.argtypes = [p, p, i, i, i, i, i, p]
    return fn


def voxel_vote(events: torch.Tensor, num_bins: int, height: int,
               width: int) -> torch.Tensor:
    """[B, M, 6] event rows -> [B, nbins, H, W] f32 trilinear vote.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    on the current stream or raises.
    """
    _check(events)
    if events.device.type != "cuda":
        return voxel_vote_plain(events, num_bins, height, width)
    events = events.contiguous()
    bsz, m, _ = events.shape
    out = torch.zeros(bsz, num_bins, height, width, dtype=torch.float32,
                      device=events.device)
    fn = _kernel()
    with torch.cuda.device(events.device):
        stream = torch.cuda.current_stream(events.device).cuda_stream
        err = fn(events.data_ptr(), out.data_ptr(), bsz, m, num_bins, height,
                 width, stream)
    if err != 0:
        raise RuntimeError(f"voxel_vote kernel failed: cudaError_t {err}")
    voxel_vote.launches += 1
    return out


voxel_vote.launches = 0

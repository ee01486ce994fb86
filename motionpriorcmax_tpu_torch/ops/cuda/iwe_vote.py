"""Bilinear IWE vote, forward and backward: the Hopper kernels and their
plain versions.

Port of the TPU kernels `motionpriorcmax_tpu/ops/pallas/iwe_vote.py`
(`iwe_vote_pallas_sorted` and `iwe_vote_pallas`).  The port computes the
exact f32 function of the JAX `'direct'` path
(`motionpriorcmax_tpu/ops/events.py::iwe_bilinear_vote`), not the TPU
kernels' bf16 tap tiles; events need not be sorted.  The CUDA source is
`motionpriorcmax_tpu_torch/csrc/iwe_vote.cu`; its header gives the bound
and the design.

  iwe_vote(coords, weight, height, width)  the differentiable vote
  iwe_vote_fwd / iwe_vote_bwd              the two launches (counted)
  iwe_vote_fwd_plain / iwe_vote_bwd_plain  the same functions in PyTorch
  iwe_vote_banded_plain                    the forward kernel's partition of
                                           the taps (chunks, row band, direct
                                           taps) in PyTorch, with its counts

On a CUDA tensor `iwe_vote_fwd` / `iwe_vote_bwd` launch their kernel or
raise; on a CPU tensor they run the plain version.  `.launches` on each
counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch


def _check(coords: torch.Tensor, weight: torch.Tensor) -> None:
    if coords.dim() != 3 or coords.shape[-1] != 2:
        raise ValueError(f"coords must be [B, M, 2], got {tuple(coords.shape)}")
    if tuple(weight.shape) != tuple(coords.shape[:2]):
        raise ValueError(f"weight must be {tuple(coords.shape[:2])}, got "
                         f"{tuple(weight.shape)}")
    if coords.dtype != torch.float32 or weight.dtype != torch.float32:
        raise TypeError("coords and weight must be float32")
    if coords.device != weight.device:
        raise ValueError(f"coords on {coords.device}, weight on {weight.device}")


def _taps(coords: torch.Tensor, height: int, width: int):
    """floor(c + 1e-6) taps, fractions and per-corner masks.

    Coordinates are first clamped to [-3, size + 2], where every tap is
    still outside the image (as every tap of the unclamped coordinate was),
    so the integer cast is defined for any input; the kernel does the same.
    """
    y = coords[..., 0].clamp(-3.0, height + 2.0)
    x = coords[..., 1].clamp(-3.0, width + 2.0)
    fly = torch.floor(y + 1e-6)
    flx = torch.floor(x + 1e-6)
    fy, fx = y - fly, x - flx
    y1, x1 = fly.long(), flx.long()
    my0 = (y1 >= 0) & (y1 < height)
    my1 = (y1 + 1 >= 0) & (y1 + 1 < height)
    mx0 = (x1 >= 0) & (x1 < width)
    mx1 = (x1 + 1 >= 0) & (x1 + 1 < width)
    # (dy, dx, wy, wx, mask) per corner, the JAX corner order.
    corners = ((0, 0, 1.0 - fy, 1.0 - fx, my0 & mx0),
               (1, 0, fy, 1.0 - fx, my1 & mx0),
               (0, 1, 1.0 - fy, fx, my0 & mx1),
               (1, 1, fy, fx, my1 & mx1))
    return y1, x1, corners


def _flat_index(y1, x1, dy, dx, mask, height, width):
    """Flat [B*H*W] index of a corner; masked corners point at 0."""
    b = torch.arange(y1.shape[0], device=y1.device)[:, None]
    idx = (b * height + y1 + dy) * width + x1 + dx
    return torch.where(mask, idx, torch.zeros_like(idx))


def iwe_vote_fwd_plain(coords: torch.Tensor, weight: torch.Tensor,
                       height: int, width: int) -> torch.Tensor:
    """[B, M, 2] (y, x), [B, M] -> [B, H, W] f32 bilinear vote (plain)."""
    _check(coords, weight)
    bsz = coords.shape[0]
    y1, x1, corners = _taps(coords, height, width)
    out = torch.zeros(bsz * height * width, dtype=torch.float32,
                      device=coords.device)
    for dy, dx, wy, wx, mask in corners:
        idx = _flat_index(y1, x1, dy, dx, mask, height, width)
        val = torch.where(mask, wy * wx * weight, torch.zeros_like(weight))
        out.index_add_(0, idx.reshape(-1), val.reshape(-1))
    return out.reshape(bsz, height, width)


# The forward kernel's partition (csrc/iwe_vote.cu): chunks of VOTE_CHUNK
# consecutive events of one batch row, a shared-memory band of
# vote_band_rows(H, W) image rows, used when it holds at least BAND_SHARE
# of the chunk's live taps and at least one per MIN_PIXELS_PER_TAP pixels
# of the rows it flushes.
VOTE_CHUNK = 4096
BAND_BYTES = 100 * 1024
BAND_SHARE = (3, 4)
MIN_PIXELS_PER_TAP = 8


def vote_band_rows(height: int, width: int) -> int:
    """Rows of the forward kernel's shared-memory band: as many as
    BAND_BYTES holds (two blocks per SM), at most the image's.  A row takes
    the kernel's band_stride(width) floats: width + 3 rounded up to 4, and
    4 more when that is a multiple of 32."""
    stride = (width + 6) // 4 * 4
    stride += 4 if stride % 32 == 0 else 0
    return min(height, BAND_BYTES // (4 * stride))


def iwe_vote_banded_plain(coords: torch.Tensor, weight: torch.Tensor,
                          height: int, width: int, chunk: int = VOTE_CHUNK,
                          band_rows: Optional[int] = None
                          ) -> Tuple[torch.Tensor, int, int]:
    """The forward kernel's partition in PyTorch: (vote [B, H, W], taps
    voted through the band, taps voted directly).

    Each chunk of `chunk` consecutive events of a batch row finds its live
    tap rows (weight != 0, tap in the image) lo..hi, places a band of
    `band_rows` rows at rs = clamp(lo // 8 * 8, 0, max(H - band_rows, 0))
    and counts the live taps in rows [rs, top], top = min(hi, rs +
    band_rows - 1); if they are at least BAND_SHARE of the chunk's live
    taps and one per MIN_PIXELS_PER_TAP pixels of rows [lo, top], those
    taps go to the band and the chunk's others directly, else all go
    directly.  The image is the sum of both parts.
    """
    _check(coords, weight)
    if band_rows is None:
        band_rows = vote_band_rows(height, width)
    bsz, m = weight.shape
    pad = -m % chunk
    c = torch.nn.functional.pad(coords, (0, 0, 0, pad))
    v = torch.nn.functional.pad(weight, (0, pad))
    y1, x1, corners = _taps(c, height, width)
    live = v != 0
    big = 1 << 30

    def per_chunk(t):                       # [B, M'] -> [B, chunks, chunk]
        return t.reshape(bsz, -1, chunk)

    def per_event(t):                       # [B, chunks] -> [B, M']
        return t[..., None].expand(-1, -1, chunk).reshape(bsz, -1)

    def chunk_sum(ts):
        return sum(per_chunk(t).sum(-1) for t in ts)

    taps = [mask & live for _, _, _, _, mask in corners]
    rows = [y1 + dy for dy, _, _, _, _ in corners]
    lo = torch.stack([per_chunk(torch.where(t, r, big)).amin(-1)
                      for t, r in zip(taps, rows)]).amin(0)
    hi = torch.stack([per_chunk(torch.where(t, r, -1)).amax(-1)
                      for t, r in zip(taps, rows)]).amax(0)
    rs = torch.clamp(lo // 8 * 8, 0, max(height - band_rows, 0))
    top = torch.minimum(hi, rs + band_rows - 1)
    in_rows = [t & (r >= per_event(rs)) & (r <= per_event(top))
               for t, r in zip(taps, rows)]
    n_rows, n_live = chunk_sum(in_rows), chunk_sum(taps)
    num, den = BAND_SHARE
    use = ((hi >= 0) & (den * n_rows >= num * n_live)
           & (MIN_PIXELS_PER_TAP * n_rows >= (top - lo + 1) * width)
           & (band_rows > 0))
    out = torch.zeros(2, bsz * height * width, dtype=torch.float32,
                      device=coords.device)
    n_band = n_direct = 0
    for (dy, dx, wy, wx, _), t, r in zip(corners, taps, in_rows):
        idx = _flat_index(y1, x1, dy, dx, t, height, width)
        val = torch.where(t, wy * wx * v, torch.zeros_like(v))
        to_band = r & per_event(use)
        out[0].index_add_(0, idx.reshape(-1),
                          torch.where(to_band, val, 0.0).reshape(-1))
        out[1].index_add_(0, idx.reshape(-1),
                          torch.where(to_band, 0.0, val).reshape(-1))
        n_band += int(to_band.sum())
        n_direct += int((t & ~to_band).sum())
    return out.sum(0).reshape(bsz, height, width), n_band, n_direct


def iwe_vote_bwd_plain(coords: torch.Tensor, weight: torch.Tensor,
                       grad: torch.Tensor, height: int, width: int,
                       need_dweight: bool = True
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Cotangents (d coords [B, M, 2], d weight [B, M] or None) of the vote
    for the image cotangent grad [B, H, W] (plain)."""
    _check(coords, weight)
    y1, x1, corners = _taps(coords, height, width)
    gflat = grad.reshape(-1)
    gk = []
    for dy, dx, _, _, mask in corners:
        idx = _flat_index(y1, x1, dy, dx, mask, height, width)
        gk.append(torch.where(mask, gflat[idx], torch.zeros_like(weight)))
    # The row weights (1 - fy, fy) and column weights (1 - fx, fx).
    (_, _, wy0, wx0, _), (_, _, wy1, _, _), (_, _, _, wx1, _), _ = corners
    a00, a10, a01, a11 = (g * weight for g in gk)
    dfy = wx0 * (a10 - a00) + wx1 * (a11 - a01)
    dfx = wy0 * (a01 - a00) + wy1 * (a11 - a10)
    dweight = None
    if need_dweight:
        dweight = (wy0 * wx0 * gk[0] + wy1 * wx0 * gk[1]
                   + wy0 * wx1 * gk[2] + wy1 * wx1 * gk[3])
    return torch.stack([dfy, dfx], dim=-1), dweight


@functools.lru_cache(maxsize=None)
def _kernels():
    """The built library's two C entry points, argument types declared."""
    from .build import load_library

    lib = load_library("iwe_vote")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.iwe_vote_fwd_chunk.restype = i
    if lib.iwe_vote_fwd_chunk() != VOTE_CHUNK:
        raise RuntimeError("csrc/iwe_vote.cu's chunk differs from VOTE_CHUNK")
    fwd = lib.iwe_vote_fwd
    fwd.restype = i
    fwd.argtypes = [p, p, p, i, i, ll, ll, i, i, i, p]
    bwd = lib.iwe_vote_bwd
    bwd.restype = i
    bwd.argtypes = [p, p, p, p, p, i, i, ll, ll, ll, i, i, p]
    return fwd, bwd


def _grad_layout(grad: torch.Tensor, height: int, width: int):
    """(cotangent, batch stride) as the backward kernel reads it: each
    [H, W] image contiguous, any batch stride (a `select(1, k)` of a
    [B, 2, H, W] cotangent is read where it lies).  A cotangent whose
    images are not each contiguous is copied."""
    if grad.stride(2) != 1 or grad.stride(1) != width:
        grad = grad.contiguous()
    return grad, grad.stride(0)


def _kernel_layout(coords: torch.Tensor, weight: torch.Tensor):
    """Batch strides for the kernel, which needs the (y, x) pairs and the
    weights contiguous within each batch row (any batch stride)."""
    if coords.stride(2) != 1 or coords.stride(1) != 2 or weight.stride(1) != 1:
        raise ValueError("coords [B, M, 2] / weight [B, M] must be contiguous "
                         "within each batch row")
    if coords.data_ptr() % 8 != 0:
        raise ValueError("coords must be 8-byte aligned (float2 loads)")
    return coords.stride(0), weight.stride(0)


def iwe_vote_fwd(coords: torch.Tensor, weight: torch.Tensor, height: int,
                 width: int) -> torch.Tensor:
    """[B, M, 2] (y, x) f32, [B, M] f32 -> [B, H, W] f32 vote.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    on the current stream or raises.  The kernel takes a band of
    vote_band_rows(height, width) rows per chunk (iwe_vote_banded_plain
    is its partition).
    """
    _check(coords, weight)
    if coords.device.type != "cuda":
        return iwe_vote_fwd_plain(coords, weight, height, width)
    cstride, wstride = _kernel_layout(coords, weight)
    bsz, m = weight.shape
    out = torch.zeros(bsz, height, width, dtype=torch.float32,
                      device=coords.device)
    fwd, _ = _kernels()
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream(coords.device).cuda_stream
        err = fwd(coords.data_ptr(), weight.data_ptr(), out.data_ptr(), bsz, m,
                  cstride, wstride, height, width,
                  vote_band_rows(height, width), stream)
    if err != 0:
        raise RuntimeError(f"iwe_vote_fwd kernel failed: cudaError_t {err}")
    iwe_vote_fwd.launches += 1
    return out


def iwe_vote_bwd(coords: torch.Tensor, weight: torch.Tensor,
                 grad: torch.Tensor, height: int, width: int,
                 need_dweight: bool = True
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(d coords [B, M, 2], d weight [B, M] or None) for grad [B, H, W].

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    on the current stream or raises.  The kernel reads grad where it lies
    when each [H, W] image is contiguous, at any batch stride: autograd
    hands each polarity half of `make_iwes`' stack the view select(1, k)
    of the [B, 2, H, W] cotangent.  Only a grad whose images are not each
    contiguous is copied.
    """
    _check(coords, weight)
    bsz, m = weight.shape
    if tuple(grad.shape) != (bsz, height, width) or grad.dtype != torch.float32:
        raise ValueError(f"grad must be float32 {(bsz, height, width)}, got "
                         f"{grad.dtype} {tuple(grad.shape)}")
    if coords.device.type != "cuda":
        return iwe_vote_bwd_plain(coords, weight, grad, height, width,
                                  need_dweight)
    if grad.device != coords.device:
        raise ValueError(f"grad on {grad.device}, coords on {coords.device}")
    cstride, wstride = _kernel_layout(coords, weight)
    grad, gstride = _grad_layout(grad, height, width)
    dcoords = torch.empty(bsz, m, 2, dtype=torch.float32, device=coords.device)
    dweight = (torch.empty(bsz, m, dtype=torch.float32, device=coords.device)
               if need_dweight else None)
    _, bwd = _kernels()
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream(coords.device).cuda_stream
        err = bwd(coords.data_ptr(), weight.data_ptr(), grad.data_ptr(),
                  dcoords.data_ptr(),
                  dweight.data_ptr() if dweight is not None else None,
                  bsz, m, cstride, wstride, gstride, height, width, stream)
    if err != 0:
        raise RuntimeError(f"iwe_vote_bwd kernel failed: cudaError_t {err}")
    iwe_vote_bwd.launches += 1
    return dcoords, dweight


iwe_vote_fwd.launches = 0
iwe_vote_bwd.launches = 0


class IweVote(torch.autograd.Function):
    """The vote with its backward kernel as the gradient."""

    @staticmethod
    def forward(ctx, coords, weight, height, width):
        ctx.save_for_backward(coords, weight)
        ctx.hw = (height, width)
        return iwe_vote_fwd(coords, weight, height, width)

    @staticmethod
    def backward(ctx, grad):
        coords, weight = ctx.saved_tensors
        need_dc, need_dw = ctx.needs_input_grad[:2]
        if not (need_dc or need_dw):
            return None, None, None, None
        dcoords, dweight = iwe_vote_bwd(coords, weight, grad, *ctx.hw,
                                        need_dweight=need_dw)
        return (dcoords if need_dc else None), dweight, None, None


def iwe_vote(coords: torch.Tensor, weight: torch.Tensor, height: int,
             width: int) -> torch.Tensor:
    """Differentiable bilinear vote [B, M, 2], [B, M] -> [B, H, W] f32.

    Semantics of the reference bilinear_vote_tensor: floor with a +1e-6
    nudge, four corner votes with products of the fractional weights, each
    corner masked to the image.  Gradients reach coords and weight.
    """
    return IweVote.apply(coords, weight, height, width)

"""Correlation-window lookup: the Hopper kernel and its plain version.

Port of the TPU kernel `motionpriorcmax_tpu/ops/pallas/corr_window.py`
(`corr_window_pallas`) fused with the shared-fraction bilinear combine of
`motionpriorcmax_tpu/models/raft_spline/corr.py::_window_lookup`.  The CUDA
source is `motionpriorcmax_tpu_torch/csrc/corr_window.cu`; its header note
gives the bound and the design.

Entry points, each with a plain PyTorch version of the same signature that
runs on CPU tensors; on a CUDA tensor each launches its kernel or raises,
and counts the launch on its `.launches`:

  corr_window_lookup      one level's features into their channel slab
                          (`corr_window_lookup_plain`)
  corr_window_lookup_bwd  the transpose: d corr (the TPU kernel `_vjp_bwd`,
                          fused with the combine's transpose), d cx, d cy
                          (`corr_window_lookup_bwd_plain`)
  CorrPyramidLookup       the autograd Function over all pyramid levels: the
                          forward per level into one slab, the backward per
                          level from the slab's cotangent
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

# The lookup radius of every RAFT-Spline config, and the only one the
# kernel is built for (kRadius in csrc/corr_window.cu).
RADIUS = 4


def extract_windows(corr_flat: torch.Tensor, rows0: torch.Tensor,
                    cols0: torch.Tensor, win: int) -> torch.Tensor:
    """window[n, i, j] = corr_flat[n, rows0[n]+i, cols0[n]+j], 0 outside.

    Plain version of the TPU kernel's function (`corr_window_pallas`): a
    selection, exact in any dtype.  corr_flat [N, H2, W2]; rows0/cols0 [N]
    integer origins (may lie out of range).  Returns [N, win, win] float32.
    """
    n, h2, w2 = corr_flat.shape
    offs = torch.arange(win, device=corr_flat.device)
    rows = rows0.long()[:, None] + offs[None, :]                 # [N, win]
    cols = cols0.long()[:, None] + offs[None, :]
    row_ok = (rows >= 0) & (rows < h2)
    col_ok = (cols >= 0) & (cols < w2)
    flat_idx = (rows.clamp(0, h2 - 1)[:, :, None] * w2
                + cols.clamp(0, w2 - 1)[:, None, :])             # [N, win, win]
    vals = torch.gather(corr_flat.reshape(n, h2 * w2), 1,
                        flat_idx.reshape(n, win * win)).reshape(n, win, win)
    ok = row_ok[:, :, None] & col_ok[:, None, :]
    return torch.where(ok, vals.float(), torch.zeros((), device=vals.device))


def window_lookup_plain(corr_flat: torch.Tensor, cx: torch.Tensor,
                        cy: torch.Tensor, radius: int) -> torch.Tensor:
    """[N, (2r+1)^2] bilinear window features, row-major over (dy, dx).

    `_window_lookup` of the JAX package: one integer-aligned [2r+2, 2r+2]
    window per map at (floor(cy) - r, floor(cx) - r), combined with the
    shared bilinear fractions.  Zero outside the map.
    """
    n = corr_flat.shape[0]
    win = 2 * radius + 2
    x0 = torch.floor(cx)
    y0 = torch.floor(cy)
    fx = (cx - x0)[:, None, None]
    fy = (cy - y0)[:, None, None]
    # The kernel clamps the origin the same way before its integer cast.
    h2, w2 = corr_flat.shape[-2:]
    x0 = x0.clamp(-radius - 2, w2 + radius)
    y0 = y0.clamp(-radius - 2, h2 + radius)
    window = extract_windows(corr_flat, y0.long() - radius,
                             x0.long() - radius, win)
    w00 = window[:, :-1, :-1]
    w01 = window[:, :-1, 1:]
    w10 = window[:, 1:, :-1]
    w11 = window[:, 1:, 1:]
    feat = ((1 - fy) * ((1 - fx) * w00 + fx * w01)
            + fy * ((1 - fx) * w10 + fx * w11))
    return feat.reshape(n, (2 * radius + 1) ** 2)


def _check(corr, cx, cy, radius, out, chan_off):
    if corr.dim() != 5:
        raise ValueError(f"corr must be [T, B, Q, H2, W2], got {tuple(corr.shape)}")
    t, b, q = corr.shape[:3]
    if tuple(cx.shape) != (t, b, q) or tuple(cy.shape) != (t, b, q):
        raise ValueError(f"cx/cy must be {(t, b, q)}, got {tuple(cx.shape)} "
                         f"and {tuple(cy.shape)}")
    if corr.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"corr must be float32 or bfloat16, got {corr.dtype}")
    if cx.dtype != torch.float32 or cy.dtype != torch.float32:
        raise TypeError("cx/cy must be float32")
    if out.dtype != torch.float32:
        raise TypeError("out must be float32")
    if radius != RADIUS:
        raise ValueError(f"the kernel is built for radius {RADIUS}, got {radius}")
    k = (2 * radius + 1) ** 2
    if (out.dim() != 4 or out.shape[0] != b
            or out.shape[2] * out.shape[3] != q
            or not 0 <= chan_off <= out.shape[1] - t * k):
        raise ValueError(
            f"out {tuple(out.shape)} cannot hold channels [{chan_off}, "
            f"{chan_off + t * k}) of a [B={b}, C, h1*w1={q}] lookup")
    devices = {x.device for x in (corr, cx, cy, out)}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")
    for name, x in (("corr", corr), ("cx", cx), ("cy", cy), ("out", out)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def corr_window_lookup_plain(corr: torch.Tensor, cx: torch.Tensor,
                             cy: torch.Tensor, radius: int, out: torch.Tensor,
                             chan_off: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same signature and result."""
    t, b, q, h2, w2 = corr.shape
    k = (2 * radius + 1) ** 2
    feat = window_lookup_plain(corr.reshape(-1, h2, w2), cx.reshape(-1),
                               cy.reshape(-1), radius)          # [T*B*Q, K]
    feat = feat.reshape(t, b, q, k).permute(1, 0, 3, 2)         # [B, T, K, Q]
    out.view(b, -1, q)[:, chan_off:chan_off + t * k] = feat.reshape(b, t * k, q)
    return out


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built kernel's C entry point, with its argument types declared."""
    from .build import load_library

    fn = load_library("corr_window").corr_window_lookup
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def _is_cuda(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def corr_window_lookup(corr: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                       radius: int, out: torch.Tensor,
                       chan_off: int) -> torch.Tensor:
    """Look up one pyramid level and write it into its channel slab of `out`.

    Args:
      corr: [T, B, Q, H2, W2] float32 or bfloat16 level volume, one map per
        query (Q = h1 * w1 query pixels).
      cx, cy: [T, B, Q] float32 window centres in level pixels.
      radius: r, which must be RADIUS (4); the features are the
        (2r+1)^2 = 81 bilinear samples.
      out: [B, C, h1, w1] float32; the lookup writes channels
        chan_off + t * K + k, K = (2r+1)^2 (level-major, then target, then K
        row-major over (dy, dx)), and nothing else.
      chan_off: first channel of this level's slab.

    Returns `out`.  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel on the current stream or raises.
    """
    _check(corr, cx, cy, radius, out, chan_off)
    if not _is_cuda(corr):
        return corr_window_lookup_plain(corr, cx, cy, radius, out, chan_off)
    if torch.is_grad_enabled() and (corr.requires_grad or cx.requires_grad
                                    or cy.requires_grad):
        raise ValueError(
            "corr_window_lookup writes its slab in place and carries no "
            "gradient; differentiate through CorrPyramidLookup")
    fn = _kernel()
    t, b, q, h2, w2 = corr.shape
    with torch.cuda.device(corr.device):
        stream = torch.cuda.current_stream(corr.device).cuda_stream
        err = fn(corr.data_ptr(), int(corr.dtype == torch.bfloat16),
                 cx.data_ptr(), cy.data_ptr(), out.data_ptr(), t * b * q,
                 h2, w2, radius, b, q, out.shape[1], chan_off, stream)
    if err != 0:
        raise RuntimeError(f"corr_window_lookup kernel failed: cudaError_t {err}")
    corr_window_lookup.launches += 1
    return out


corr_window_lookup.launches = 0


# -- backward -----------------------------------------------------------------

def corr_window_lookup_bwd_plain(corr: torch.Tensor, cx: torch.Tensor,
                                 cy: torch.Tensor, radius: int,
                                 g: torch.Tensor, chan_off: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Plain PyTorch version of the backward kernel, same signature and
    result: (d corr in corr's dtype, d cx, d cy)."""
    t, b, q, h2, w2 = corr.shape
    n = t * b * q
    side = 2 * radius + 1
    win = side + 1
    k = side * side
    gq = g.view(b, -1, q)[:, chan_off:chan_off + t * k]          # [B, T*K, Q]
    gq = gq.reshape(b, t, k, q).permute(1, 0, 3, 2).reshape(n, side, side)
    gq = gq.float()
    cxf, cyf = cx.reshape(n), cy.reshape(n)
    x0 = torch.floor(cxf)
    y0 = torch.floor(cyf)
    fx = (cxf - x0)[:, None, None]
    fy = (cyf - y0)[:, None, None]
    x0 = x0.clamp(-radius - 2, w2 + radius).long() - radius
    y0 = y0.clamp(-radius - 2, h2 + radius).long() - radius
    # The window cotangent: each feature's four bilinear weights.
    cot = torch.zeros(n, win, win, dtype=torch.float32, device=corr.device)
    cot[:, :-1, :-1] += (1 - fy) * (1 - fx) * gq
    cot[:, :-1, 1:] += (1 - fy) * fx * gq
    cot[:, 1:, :-1] += fy * (1 - fx) * gq
    cot[:, 1:, 1:] += fy * fx * gq
    w = extract_windows(corr.reshape(n, h2, w2), y0, x0, win)    # [N, win, win]
    d_fx = (gq * ((1 - fy) * (w[:, :-1, 1:] - w[:, :-1, :-1])
                  + fy * (w[:, 1:, 1:] - w[:, 1:, :-1]))).sum(dim=(1, 2))
    d_fy = (gq * ((1 - fx) * (w[:, 1:, :-1] - w[:, :-1, :-1])
                  + fx * (w[:, 1:, 1:] - w[:, :-1, 1:]))).sum(dim=(1, 2))
    # Scatter the in-range taps into their maps; the others drop theirs.
    offs = torch.arange(win, device=corr.device)
    rows = y0[:, None] + offs[None, :]
    cols = x0[:, None] + offs[None, :]
    ok = (((rows >= 0) & (rows < h2))[:, :, None]
          & ((cols >= 0) & (cols < w2))[:, None, :])
    flat = (rows.clamp(0, h2 - 1)[:, :, None] * w2
            + cols.clamp(0, w2 - 1)[:, None, :]).reshape(n, win * win)
    d_corr = torch.zeros(n, h2 * w2, dtype=torch.float32, device=corr.device)
    d_corr.scatter_add_(1, flat, torch.where(ok, cot, 0.0).reshape(n, -1))
    return (d_corr.reshape(corr.shape).to(corr.dtype),
            d_fx.reshape(cx.shape), d_fy.reshape(cy.shape))


@functools.lru_cache(maxsize=None)
def _kernel_bwd():
    """The built backward kernel's C entry point, argument types declared."""
    from .build import load_library

    fn = load_library("corr_window").corr_window_lookup_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def corr_window_lookup_bwd(corr: torch.Tensor, cx: torch.Tensor,
                           cy: torch.Tensor, radius: int, g: torch.Tensor,
                           chan_off: int
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The lookup's transpose for one pyramid level.

    Args:
      corr, cx, cy, radius, chan_off: as `corr_window_lookup`.
      g: [B, C, h1, w1] float32 cotangent of the lookup's output slab; the
        level reads channels chan_off .. chan_off + T * K.

    Returns (d corr [T, B, Q, H2, W2] in corr's dtype, summed in f32;
    d cx, d cy [T, B, Q] f32).  A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel on the current stream or raises.
    """
    _check(corr, cx, cy, radius, g, chan_off)
    if not _is_cuda(corr):
        return corr_window_lookup_bwd_plain(corr, cx, cy, radius, g, chan_off)
    fn = _kernel_bwd()
    t, b, q, h2, w2 = corr.shape
    d_corr = torch.empty_like(corr)
    d_cx = torch.empty_like(cx)
    d_cy = torch.empty_like(cy)
    with torch.cuda.device(corr.device):
        stream = torch.cuda.current_stream(corr.device).cuda_stream
        err = fn(corr.data_ptr(), int(corr.dtype == torch.bfloat16),
                 cx.data_ptr(), cy.data_ptr(), g.data_ptr(), d_corr.data_ptr(),
                 d_cx.data_ptr(), d_cy.data_ptr(), t * b * q, h2, w2, radius,
                 b, q, g.shape[1], chan_off, stream)
    if err != 0:
        raise RuntimeError(
            f"corr_window_lookup_bwd kernel failed: cudaError_t {err}")
    corr_window_lookup_bwd.launches += 1
    return d_corr, d_cx, d_cy


corr_window_lookup_bwd.launches = 0


class CorrPyramidLookup(torch.autograd.Function):
    """The lookup over every pyramid level, differentiable.

    apply(radius, h1, w1, corr_0, cx_0, cy_0, corr_1, cx_1, cy_1, ...) ->
    [B, sum_l T_l * K, h1, w1] float32, level-major.  The forward runs
    `corr_window_lookup` per level into one slab; the backward runs
    `corr_window_lookup_bwd` per level on the slab's cotangent and returns
    d corr, d cx, d cy of every level.  The volumes are saved as they are
    (they are the pyramid the caller keeps), nothing else of size.
    """

    @staticmethod
    def forward(ctx, radius: int, h1: int, w1: int, *tensors: torch.Tensor):
        if len(tensors) % 3:
            raise ValueError("expected (corr, cx, cy) per level")
        levels = [tensors[i:i + 3] for i in range(0, len(tensors), 3)]
        b = levels[0][0].shape[1]
        k = (2 * radius + 1) ** 2
        total = sum(corr.shape[0] for corr, _, _ in levels) * k
        out = torch.empty(b, total, h1, w1, dtype=torch.float32,
                          device=levels[0][0].device)
        chan_off = 0
        for corr, cx, cy in levels:
            corr_window_lookup(corr, cx, cy, radius, out, chan_off)
            chan_off += corr.shape[0] * k
        ctx.radius = radius
        ctx.save_for_backward(*tensors)
        return out

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        tensors = ctx.saved_tensors
        g = grad_out.contiguous()
        k = (2 * ctx.radius + 1) ** 2
        grads = []
        chan_off = 0
        for i in range(0, len(tensors), 3):
            corr, cx, cy = tensors[i:i + 3]
            if any(ctx.needs_input_grad[3 + i:6 + i]):
                grads.extend(corr_window_lookup_bwd(corr, cx, cy, ctx.radius,
                                                    g, chan_off))
            else:
                grads.extend((None, None, None))
            chan_off += corr.shape[0] * k
        return (None, None, None, *grads)

"""Correlation-window lookup: the Hopper kernel and its plain version.

Port of the TPU kernel `motionpriorcmax_tpu/ops/pallas/corr_window.py`
(`corr_window_pallas`) fused with the shared-fraction bilinear combine of
`motionpriorcmax_tpu/models/raft_spline/corr.py::_window_lookup`.  The CUDA
source is `motionpriorcmax_tpu_torch/csrc/corr_window.cu`; its header note
gives the bound and the design.

`corr_window_lookup` is the one entry point.  On a CUDA tensor it launches
the kernel (or raises); on a CPU tensor it runs `corr_window_lookup_plain`,
the same function in plain PyTorch.  `corr_window_lookup.launches` counts the
kernel launches.

This slice is forward only: the volume cotangent (the TPU kernel's
`_vjp_bwd`) lands with RAFT training.
"""

from __future__ import annotations

import ctypes
import functools

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
        raise NotImplementedError(
            "backward kernel not ported (RAFT training slice)")
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

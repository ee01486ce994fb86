"""Banded softmax interpolation, forward and backward: the Hopper kernels
and their plain versions.

Port of the TPU kernel `motionpriorcmax_tpu/ops/pallas/softmax_interp.py`
(`softmax_interp_pallas`: `_run_fwd` and `_vjp_bwd`):

    out[g, q, :] = sum_n w[g, q, n] vals[g, n, :] / max(sum_n w[g, q, n], 1e-30)
    w[g, q, n]   = exp(-|queries[q] - db[g, n]|^2 / temp)

over the db slots n that the row band scans for q's block of 512 queries,
and d vals = w^T (g_out / max(den, 1e-30)); nothing flows to the queries,
the db or the band.  There is no max-subtraction: a query whose scanned
points all lie far away gets 0.  The weight is the TPU kernel's 'vpu' form,
exp2 of the squared DIFFERENCE of coordinates prescaled by
sqrt(log2(e) / temp); the port computes that form for `cross_impl` 'mxu'
too (the TPU's expansion q.q + d.d - 2 q.d exists for its matrix unit and
loses px^2-scale bits at image coordinates), and raises on anything else.
`exp_dtype='bfloat16'` rounds the exponent, the weights and the values
(forward) or scaled cotangents (backward) to bf16 and sums in f32.

The band defines the function: when trajectories move farther than the
margin, the set of scanned slots changes the result.  `scan_slots` computes
each query block's slot range exactly as `_tile_band` does, on the device,
and both the kernels and the plain versions scan those ranges.  The CUDA
source is `motionpriorcmax_tpu_torch/csrc/softmax_interp.cu`; its header
gives the bound and the design.

  softmax_interp(queries, db, vals, temp, band, ...)  the differentiable op
  scan_slots(queries, band, groups, n)                the scanned ranges
  softmax_interp_fwd / softmax_interp_bwd             the launches (counted)
  softmax_interp_fwd_plain / softmax_interp_bwd_plain the same in PyTorch

On a CUDA tensor the launch functions run their kernel or raise; on a CPU
tensor they run the plain version.  `.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import numpy as np
import torch

from ...device import no_tf32

BQ = 512            # queries per band block (the TPU kernel's BQ)
BN = 1024           # db slots per band tile (the TPU kernel's BN)
MAX_CHANNELS = 8    # value channels the kernels are built for
_LOG2E = 1.4426950408889634
_EXP_DTYPES = ("float32", "bfloat16")


def _prescale(temp: float) -> float:
    """sqrt(log2(e) / temp) in f32, as the TPU kernel computes it."""
    return float(np.sqrt(np.float32(_LOG2E) / np.float32(temp)))


def _band_rows(band, device) -> torch.Tensor:
    """(margin_px, cell, wq) as a tuple, a [3] or a [R, 3] tensor -> [R, 3]
    f32 on `device` (R = 1: one band for every group; R = G: per group)."""
    if isinstance(band, (tuple, list)):
        return torch.tensor([list(band)], dtype=torch.float32, device=device)
    band = band.to(device=device, dtype=torch.float32)
    if band.dim() == 2 and band.shape[1] == 3:
        return band
    if band.shape != (3,):
        raise ValueError(f"band must be 3 values or [R, 3], got "
                         f"{tuple(band.shape)}")
    return band.reshape(1, 3)


def scan_slots(queries: torch.Tensor, band, groups: int, n: int
               ) -> torch.Tensor:
    """int32 [G, ceil(Q / 512), 2]: the db slots [lo, hi) each group scans
    for each block of 512 queries (the TPU kernel's `_tile_band`).

    Queries are edge-padded to a multiple of 512 (a far pad would widen the
    last block's band); the block's row band [min y - margin, max y +
    margin] (max y clamped to 1e5) becomes whole grid rows of `wq` slots of
    height `cell`, rounded out to tiles of 1024 slots and clipped to N.  A
    margin <= 0 scans all N.  Runs on the band's device with no host sync.
    """
    rows = _band_rows(band, queries.device)
    if rows.shape[0] not in (1, groups):
        raise ValueError(f"band has {rows.shape[0]} rows for {groups} groups")
    q = queries.shape[0]
    nqb = -(-q // BQ)
    qy = queries[:, 0].to(torch.float32)
    if nqb * BQ != q:
        qy = torch.cat([qy, qy[-1:].expand(nqb * BQ - q)])
    blocks = qy.reshape(nqb, BQ)
    min_qy = blocks.min(dim=1).values[None]                  # [1, nqb]
    max_qy = torch.clamp(blocks.max(dim=1).values, max=1e5)[None]
    margin, cell, wq = (rows[:, i:i + 1] for i in range(3))  # [R, 1]
    full = float(-(-n // BN))
    lo_slot = torch.floor((min_qy - margin) / cell) * wq
    hi_slot = (torch.floor((max_qy + margin) / cell) + 1.0) * wq
    t_lo = torch.clamp(lo_slot / BN, 0.0, full).to(torch.int32)
    t_hi = torch.clamp(torch.ceil(hi_slot / BN), 0.0, full).to(torch.int32)
    use = margin > 0
    t_lo = torch.where(use, t_lo, torch.zeros_like(t_lo))
    t_hi = torch.where(use, t_hi, torch.full_like(t_hi, int(full)))
    lo = (t_lo * BN).expand(groups, nqb)
    hi = torch.clamp(t_hi * BN, max=n).expand(groups, nqb)
    return torch.stack([lo, hi], dim=-1).to(torch.int32).contiguous()


def scanned_pairs(slots: torch.Tensor, q: int) -> int:
    """(query, slot) pairs the ranges make each pass compute, real queries
    only (a host sync; for bounds and reports)."""
    nqb = slots.shape[1]
    per_block = torch.full((nqb,), BQ, dtype=torch.int64)
    per_block[-1] = q - (nqb - 1) * BQ
    width = (slots[..., 1] - slots[..., 0]).clamp(min=0).long().cpu()
    return int((width * per_block[None]).sum())


def _check(queries, db, values, slots, exp_dtype):
    if queries.dim() != 2 or queries.shape[1] != 2:
        raise ValueError(f"queries must be [Q, 2], got {tuple(queries.shape)}")
    if db.dim() != 3 or db.shape[2] != 2:
        raise ValueError(f"db must be [G, N, 2], got {tuple(db.shape)}")
    if values.dim() != 3 or values.shape[0] != db.shape[0]:
        raise ValueError(f"values must be [G={db.shape[0]}, *, C], got "
                         f"{tuple(values.shape)}")
    g, q = db.shape[0], queries.shape[0]
    if tuple(slots.shape) != (g, -(-q // BQ), 2) or slots.dtype != torch.int32:
        raise ValueError(f"slots must be int32 [{g}, {-(-q // BQ)}, 2], got "
                         f"{slots.dtype} {tuple(slots.shape)}")
    if any(t.dtype != torch.float32 for t in (queries, db, values)):
        raise TypeError("queries, db and values must be float32")
    if len({queries.device, db.device, values.device, slots.device}) != 1:
        raise ValueError("queries, db, values and slots on different devices")
    if exp_dtype not in _EXP_DTYPES:
        raise ValueError(f"exp_dtype must be one of {_EXP_DTYPES}, got "
                         f"{exp_dtype!r}")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _weights_plain(queries, db_g, slots_g, rscale, bf16):
    """[Q, N] weights of one group, zero outside each block's range."""
    q, n = queries.shape[0], db_g.shape[0]
    qs, ds = queries * rscale, db_g * rscale
    ey = qs[:, None, 0] - ds[None, :, 0]
    ex = qs[:, None, 1] - ds[None, :, 1]
    e = -(ey * ey + ex * ex)
    w = torch.exp2(_bf16(e) if bf16 else e)
    if bf16:
        w = _bf16(w)
    block = torch.arange(q, device=queries.device) // BQ
    lo = slots_g[block, 0].long()[:, None]
    hi = slots_g[block, 1].long()[:, None]
    slot = torch.arange(n, device=queries.device)[None]
    return torch.where((slot >= lo) & (slot < hi), w, torch.zeros_like(w))


def softmax_interp_fwd_plain(queries, db, vals, temp, slots,
                             exp_dtype="float32"):
    """(out [G, Q, C], den [G, Q]) of the banded interpolation (plain; one
    dense [Q, N] weight matrix per group)."""
    _check(queries, db, vals, slots, exp_dtype)
    bf16 = exp_dtype == "bfloat16"
    rscale = _prescale(temp)
    v = _bf16(vals) if bf16 else vals
    outs, dens = [], []
    with no_tf32():
        for g in range(db.shape[0]):
            w = _weights_plain(queries, db[g], slots[g], rscale, bf16)
            den = w.sum(dim=1)
            outs.append((w @ v[g]) / torch.clamp(den, min=1e-30)[:, None])
            dens.append(den)
    return torch.stack(outs), torch.stack(dens)


def softmax_interp_bwd_plain(queries, db, gs, temp, slots,
                             exp_dtype="float32"):
    """d vals [G, N, C] = w^T gs for the scaled cotangent gs [G, Q, C]
    (plain)."""
    _check(queries, db, gs, slots, exp_dtype)
    bf16 = exp_dtype == "bfloat16"
    rscale = _prescale(temp)
    g_in = _bf16(gs) if bf16 else gs
    with no_tf32():
        return torch.stack([
            _weights_plain(queries, db[g], slots[g], rscale, bf16).T @ g_in[g]
            for g in range(db.shape[0])])


@functools.lru_cache(maxsize=None)
def _kernels():
    """The built library's two C entry points, argument types declared."""
    from .build import load_library

    lib = load_library("softmax_interp")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd = lib.softmax_interp_fwd
    fwd.restype = i
    fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, i, p]
    bwd = lib.softmax_interp_bwd
    bwd.restype = i
    bwd.argtypes = [p, p, p, p, p, i, i, i, i, i, f, i, p]
    return fwd, bwd


def _kernel_args(queries, db, values, slots):
    g, n, c = values.shape
    if c > MAX_CHANNELS:
        raise ValueError(f"the kernels take at most {MAX_CHANNELS} value "
                         f"channels, got {c}")
    if g > 65535:
        raise ValueError(f"the kernels take at most 65535 groups, got {g}")
    return (queries.contiguous(), db.contiguous(), values.contiguous(),
            slots.contiguous())


def softmax_interp_fwd(queries: torch.Tensor, db: torch.Tensor,
                       vals: torch.Tensor, temp: float, slots: torch.Tensor,
                       exp_dtype: str = "float32"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [G, Q, C], den [G, Q]) for queries [Q, 2], db [G, N, 2], vals
    [G, N, C] f32 and the ranges of `scan_slots`.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    on the current stream or raises.
    """
    _check(queries, db, vals, slots, exp_dtype)
    if db.device.type != "cuda":
        return softmax_interp_fwd_plain(queries, db, vals, temp, slots,
                                        exp_dtype)
    queries, db, vals, slots = _kernel_args(queries, db, vals, slots)
    g, n, c = vals.shape
    q = queries.shape[0]
    out = torch.empty(g, q, c, dtype=torch.float32, device=db.device)
    den = torch.empty(g, q, dtype=torch.float32, device=db.device)
    fwd, _ = _kernels()
    with torch.cuda.device(db.device):
        stream = torch.cuda.current_stream(db.device).cuda_stream
        err = fwd(queries.data_ptr(), db.data_ptr(), vals.data_ptr(),
                  slots.data_ptr(), out.data_ptr(), den.data_ptr(), g, q, n, c,
                  slots.shape[1], _prescale(temp), int(exp_dtype == "bfloat16"),
                  stream)
    if err != 0:
        raise RuntimeError(f"softmax_interp_fwd kernel failed: cudaError_t {err}")
    softmax_interp_fwd.launches += 1
    return out, den


def softmax_interp_bwd(queries: torch.Tensor, db: torch.Tensor,
                       gs: torch.Tensor, temp: float, slots: torch.Tensor,
                       exp_dtype: str = "float32") -> torch.Tensor:
    """d vals [G, N, C] for the scaled cotangent gs [G, Q, C] =
    g_out / max(den, 1e-30).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    on the current stream or raises.
    """
    _check(queries, db, gs, slots, exp_dtype)
    if gs.shape[1] != queries.shape[0]:
        raise ValueError(f"gs must be [G, Q={queries.shape[0]}, C], got "
                         f"{tuple(gs.shape)}")
    if db.device.type != "cuda":
        return softmax_interp_bwd_plain(queries, db, gs, temp, slots,
                                        exp_dtype)
    queries, db, gs, slots = _kernel_args(queries, db, gs, slots)
    g, q, c = gs.shape
    n = db.shape[1]
    dvals = torch.empty(g, n, c, dtype=torch.float32, device=db.device)
    _, bwd = _kernels()
    with torch.cuda.device(db.device):
        stream = torch.cuda.current_stream(db.device).cuda_stream
        err = bwd(queries.data_ptr(), db.data_ptr(), gs.data_ptr(),
                  slots.data_ptr(), dvals.data_ptr(), g, q, n, c,
                  slots.shape[1], _prescale(temp), int(exp_dtype == "bfloat16"),
                  stream)
    if err != 0:
        raise RuntimeError(f"softmax_interp_bwd kernel failed: cudaError_t {err}")
    softmax_interp_bwd.launches += 1
    return dvals


softmax_interp_fwd.launches = 0
softmax_interp_bwd.launches = 0


class SoftmaxInterp(torch.autograd.Function):
    """The interpolation with its backward kernel as the d vals gradient."""

    @staticmethod
    def forward(ctx, queries, db, vals, temp, slots, exp_dtype):
        out, den = softmax_interp_fwd(queries, db, vals, temp, slots,
                                      exp_dtype)
        ctx.save_for_backward(queries, db, den, slots)
        ctx.args = (temp, exp_dtype)
        return out

    @staticmethod
    def backward(ctx, g_out):
        if not ctx.needs_input_grad[2]:
            return None, None, None, None, None, None
        queries, db, den, slots = ctx.saved_tensors
        temp, exp_dtype = ctx.args
        gs = g_out / torch.clamp(den, min=1e-30)[..., None]
        dvals = softmax_interp_bwd(queries, db, gs.contiguous(), temp, slots,
                                   exp_dtype)
        return None, None, dvals, None, None, None


def softmax_interp(queries: torch.Tensor, db: torch.Tensor,
                   vals: torch.Tensor, temp: float = 25.0,
                   band=(0.0, 0.0, 0.0), exp_dtype: str = "float32",
                   cross_impl: str = "vpu") -> torch.Tensor:
    """out[g, q, :] = sum_n softmax_n(-|q - db[g, n]|^2 / temp) vals[g, n, :]
    over the band's scanned slots (JAX `softmax_interp_pallas`).

    Args:
      queries: [Q, 2] f32 (y, x), row-major over the band's grid when banded.
      db: [G, N, 2] f32 positions, slots row-major over the same grid.
      vals: [G, N, C] f32; the only input that receives a gradient.
      band: (margin_px, cell, wq), a [3] or a [G, 3] tensor (per-group
        margins; may be computed on the device).  margin <= 0: no band.
      exp_dtype: 'float32' or 'bfloat16' (both directions).
      cross_impl: 'vpu' or 'mxu'; both compute the difference form.

    Returns:
      [G, Q, C] f32.
    """
    if cross_impl not in ("vpu", "mxu"):
        raise ValueError(f"cross_impl must be 'vpu' or 'mxu', got "
                         f"{cross_impl!r}")
    if not math.isfinite(temp) or temp <= 0:
        raise ValueError(f"temp must be a positive number, got {temp}")
    slots = scan_slots(queries, band, db.shape[0], db.shape[1])
    return SoftmaxInterp.apply(queries, db.detach(), vals, float(temp), slots,
                               exp_dtype)

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

The kernels skip every pair whose weight is exactly 0 by a conservative
test (a lower bound of the prescaled squared distance at least `CUT`)
against bounding boxes of a warp's queries (forward) or slots (backward),
grouped along a Morton curve.  `softmax_interp_culled_plain` runs that
partition in PyTorch (`cull_pairs` counts it without the dense weights);
given a `pairs` counter, the launch functions run a build of the kernel
that counts the pairs it computes, to hold the twin's count against.

  softmax_interp(queries, db, vals, temp, band, ...)  the differentiable op
  scan_slots(queries, band, groups, n)                the scanned ranges
  softmax_interp_fwd / softmax_interp_bwd             the launches (counted)
  softmax_interp_fwd_plain / softmax_interp_bwd_plain the same in PyTorch
  softmax_interp_culled_plain                         both, through the cull
  cull_pairs(queries, db, slots, temp)                the pairs each needs

On a CUDA tensor the launch functions run their kernel or raise; on a CPU
tensor they run the plain version.  `.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ...device import no_tf32

BQ = 512            # queries per band block (the TPU kernel's BQ)
BN = 1024           # db slots per band tile (the TPU kernel's BN)
MAX_CHANNELS = 8    # value channels the kernels are built for
# The kernels' partition (csrc/softmax_interp.cu): a pair is skipped when a
# lower bound of its prescaled squared distance is at least CUT (its f32
# and bf16 weights are then exactly 0); points are grouped along a Morton
# curve of CELLS_PER_UNIT cells per prescaled unit; the backward tests
# strips of STRIP consecutive queries.
CUT = 152.0
CELLS_PER_UNIT = 2.0
WARP = 32
STRIP = 8
_PAD_CODE = 0xFFFFFFFF
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


def _exp_weights(qs, ds, bf16):
    """[Qs, Ns] weights of prescaled queries qs [Qs, 2] and points ds
    [Ns, 2]."""
    ey = qs[:, None, 0] - ds[None, :, 0]
    ex = qs[:, None, 1] - ds[None, :, 1]
    e = -(ey * ey + ex * ex)
    w = torch.exp2(_bf16(e) if bf16 else e)
    return _bf16(w) if bf16 else w


def _weights_plain(queries, db_g, slots_g, rscale, bf16):
    """[Q, N] weights of one group, zero outside each block's range."""
    q, n = queries.shape[0], db_g.shape[0]
    w = _exp_weights(queries * rscale, db_g * rscale, bf16)
    block = torch.arange(q, device=queries.device) // BQ
    lo = slots_g[block, 0].long()[:, None]
    hi = slots_g[block, 1].long()[:, None]
    slot = torch.arange(n, device=queries.device)[None]
    return torch.where((slot >= lo) & (slot < hi), w, torch.zeros_like(w))


def _fwd_from_weights(w, v):
    """(out [Q, C], den [Q]) of one group's [Q, N] weights."""
    den = w.sum(dim=1)
    return (w @ v) / torch.clamp(den, min=1e-30)[:, None], den


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
            out, den = _fwd_from_weights(
                _weights_plain(queries, db[g], slots[g], rscale, bf16), v[g])
            outs.append(out)
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


# The kernels' partition, in PyTorch.  Prescaled points are grouped along a
# Morton curve as the kernels sort them: per block of `block` items, by
# code (16-bit cells of 1 / CELLS_PER_UNIT units, 32768 at the origin,
# clamped; NaN in cell 0) and then by index, padding items last.

def _spread(v):
    v = v & 0xFFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    return (v | (v << 1)) & 0x55555555


def _morton(p):
    """int64 Morton codes of prescaled f32 points [..., 2]."""
    c = torch.floor(p * CELLS_PER_UNIT) + 32768.0
    c = torch.fmin(torch.fmax(c, c.new_zeros(())), c.new_full((), 65535.0))
    c = c.long()
    return (_spread(c[..., 0]) << 1) | _spread(c[..., 1])


def _curve_groups(p, block):
    """int64 [ceil(n / block), block / WARP, WARP]: the indices of the n
    points p [n, 2] that each warp of each block takes, -1 for padding."""
    n = p.shape[0]
    nb = -(-n // block)
    code = torch.full((nb * block,), _PAD_CODE, dtype=torch.int64,
                      device=p.device)
    code[:n] = _morton(p)
    order = torch.sort(code.view(nb, block), dim=1, stable=True).indices
    idx = order + torch.arange(nb, device=p.device)[:, None] * block
    idx = torch.where(idx < n, idx, torch.full_like(idx, -1))
    return idx.view(nb, block // WARP, WARP)


def _warp_of(warps, count):
    """int64 [count]: the flat index of the warp that takes each item."""
    flat = warps.reshape(-1, WARP)
    rows = torch.arange(flat.shape[0], device=warps.device)[:, None]
    out = torch.empty(count, dtype=torch.int64, device=warps.device)
    out[flat[flat >= 0]] = rows.expand_as(flat)[flat >= 0]
    return out


def _boxes(p, idx):
    """(y0, y1, x0, x1) [..., 4] of the points p[idx] over idx's last dim,
    -1 left out, a NaN coordinate spanning everything; empty: (inf, -inf,
    inf, -inf)."""
    inf = float("inf")
    v = p[idx.clamp(min=0)]
    ok = (idx >= 0)[..., None]
    nan = torch.isnan(v)
    lo = torch.where(ok, torch.where(nan, -inf, v), inf).amin(dim=-2)
    hi = torch.where(ok, torch.where(nan, inf, v), -inf).amax(dim=-2)
    return torch.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]], -1)


def _may_live(dy, dx):
    """Whether a pair at per-axis gaps dy, dx may have a nonzero weight (NaN
    gaps count as 0, as fmaxf takes them)."""
    zero = dy.new_zeros(())
    dy, dx = torch.fmax(dy, zero), torch.fmax(dx, zero)
    return ~(dy * dy + dx * dx >= CUT)


def _box_live(y, x, box):
    """_may_live for points (y, x) against boxes [..., 4] (broadcast)."""
    return _may_live(torch.fmax(box[..., 0] - y, y - box[..., 1]),
                     torch.fmax(box[..., 2] - x, x - box[..., 3]))


def _fwd_partition(qs):
    """The forward's warps: (query index [nqb, 16, 32], -1 for padding;
    their boxes [nqb, 16, 4]) for prescaled queries qs [Q, 2]."""
    warps = _curve_groups(qs, BQ)
    return warps, _boxes(qs, warps)


def _fwd_keep(box, ds, slots_g):
    """bool [nqb, 16, N]: the slots that each forward warp adds, for
    prescaled points ds [N, 2] and one group's ranges slots_g [nqb, 2]."""
    s = torch.arange(ds.shape[0], device=ds.device)
    inr = (s >= slots_g[:, 0:1]) & (s < slots_g[:, 1:2])
    b = box[..., None, :]
    return _box_live(ds[:, 0], ds[:, 1], b) & inr[:, None]


def _bwd_strips(qs):
    """The backward's strips of STRIP queries per query block: (boxes
    [nqb, 64, 4], real queries [nqb, 64], block boxes [nqb, 4])."""
    q = qs.shape[0]
    nqb = -(-q // BQ)
    idx = torch.arange(nqb * BQ, device=qs.device)
    idx = torch.where(idx < q, idx, torch.full_like(idx, -1))
    idx = idx.view(nqb, BQ // STRIP, STRIP)
    sbox = _boxes(qs, idx)
    qbox = torch.stack([sbox[..., 0].amin(1), sbox[..., 1].amax(1),
                        sbox[..., 2].amin(1), sbox[..., 3].amax(1)], -1)
    return sbox, (idx >= 0).sum(-1), qbox


def _bwd_live(ds, slots_g, sbox, qbox):
    """The backward's work for prescaled points ds [N, 2] and one group's
    ranges: (its warps' slots [nt, 32, 32], -1 for padding; near [N, nqb]:
    the slot is in the query block's range and within the cut of its box;
    the near lanes per warp and query block [nt, 32, nqb]; strip_live [nt,
    32, nqb, 64]: the strips each warp walks)."""
    n = ds.shape[0]
    warps = _curve_groups(ds, BN)
    s = torch.arange(n, device=ds.device)[:, None]
    near = (s >= slots_g[:, 0]) & (s < slots_g[:, 1]) & _box_live(
        ds[:, 0:1], ds[:, 1:2], qbox)
    lane_near = near[warps.clamp(min=0)] & (warps >= 0)[..., None]
    near_lanes = torch.where(lane_near, warps[..., None], -1).transpose(2, 3)
    wbox = _boxes(ds, near_lanes)[..., None, :]        # [nt, 32, nqb, 1, 4]
    live = _may_live(torch.fmax(sbox[..., 0] - wbox[..., 1],
                                wbox[..., 0] - sbox[..., 1]),
                     torch.fmax(sbox[..., 2] - wbox[..., 3],
                                wbox[..., 2] - sbox[..., 3]))
    counts = (near_lanes >= 0).sum(-1)
    return warps, near, counts, live & (counts > 0)[..., None]


def cull_pairs(queries: torch.Tensor, db: torch.Tensor, slots: torch.Tensor,
               temp: float, exp_dtype: str = "float32") -> dict:
    """The (query, slot) pairs of one pass over the band: `scanned` (every
    pair of the ranges), `needed` (a nonzero weight), `computed_fwd` and
    `computed_bwd` (the pairs the kernels' cull leaves).  Runs on the
    inputs' device without dense weights; one host sync at the end."""
    if exp_dtype not in _EXP_DTYPES:
        raise ValueError(f"exp_dtype must be one of {_EXP_DTYPES}, got "
                         f"{exp_dtype!r}")
    bf16 = exp_dtype == "bfloat16"
    rscale = _prescale(temp)
    q = queries.shape[0]
    g_count, n = db.shape[:2]
    qs = queries.to(torch.float32) * rscale
    fwarps, fbox = _fwd_partition(qs)
    nlive = (fwarps >= 0).sum(-1)
    sbox, size, qbox = _bwd_strips(qs)
    fwd = bwd = needed = torch.zeros((), dtype=torch.int64, device=db.device)
    for g in range(g_count):
        ds = db[g] * rscale
        fwd = fwd + (_fwd_keep(fbox, ds, slots[g]).sum(-1) * nlive).sum()
        _, _, counts, live = _bwd_live(ds, slots[g], sbox, qbox)
        bwd = bwd + (counts * (live * size).sum(-1)).sum()
    # Nonzero weights, per query block over its ranges, 16 groups at a time.
    host = slots.cpu()
    for b in range(slots.shape[1]):
        qb = qs[b * BQ:(b + 1) * BQ]
        for g0 in range(0, g_count, 16):
            lo = int(host[g0:g0 + 16, b, 0].min())
            hi = int(host[g0:g0 + 16, b, 1].max())
            if hi <= lo:
                continue
            sl = slots[g0:g0 + 16, b].long()
            ds = db[g0:g0 + 16, lo:hi] * rscale                  # [g, W, 2]
            w = torch.stack([_exp_weights(qb, d, bf16) for d in ds])
            s = torch.arange(lo, hi, device=db.device)
            inr = (s >= sl[:, 0:1]) & (s < sl[:, 1:2])           # [g, W]
            needed = needed + ((w != 0) & inr[:, None]).sum()
    return {"scanned": scanned_pairs(slots, q), "needed": int(needed),
            "computed_fwd": int(fwd), "computed_bwd": int(bwd)}


def softmax_interp_culled_plain(queries, db, vals, gs, temp, slots,
                                exp_dtype="float32"):
    """(out [G, Q, C], den [G, Q], d vals [G, N, C], pairs): the plain
    versions' dense weights with every pair that the kernels' cull skips
    set to 0.  The cull drops only zero weights when these equal the plain
    versions' results exactly; `pairs` counts as `cull_pairs` does, and
    `dropped` counts the nonzero weights the cull would skip (0)."""
    _check(queries, db, vals, slots, exp_dtype)
    _check(queries, db, gs, slots, exp_dtype)
    bf16 = exp_dtype == "bfloat16"
    rscale = _prescale(temp)
    v = _bf16(vals) if bf16 else vals
    g_in = _bf16(gs) if bf16 else gs
    q, n = queries.shape[0], db.shape[1]
    qs = queries * rscale
    fwarps, fbox = _fwd_partition(qs)
    fwarp_of = _warp_of(fwarps, q)
    sbox, _, qbox = _bwd_strips(qs)
    qblock = torch.arange(q, device=db.device) // BQ
    qstrip = (torch.arange(q, device=db.device) % BQ) // STRIP
    outs, dens, dvals = [], [], []
    pairs = dict(needed=0, computed_fwd=0, computed_bwd=0, dropped=0)
    with no_tf32():
        for g in range(db.shape[0]):
            w = _weights_plain(queries, db[g], slots[g], rscale, bf16)
            ds = db[g] * rscale
            keep_f = _fwd_keep(fbox, ds, slots[g]).reshape(-1, n)[fwarp_of]
            warps, near, _, live = _bwd_live(ds, slots[g], sbox, qbox)
            live_s = live.reshape(-1, *live.shape[2:])[_warp_of(warps, n)]
            keep_b = (live_s[:, qblock, qstrip] & near[:, qblock]).T
            keep_b = keep_b.contiguous()
            out, den = _fwd_from_weights(
                torch.where(keep_f, w, torch.zeros_like(w)), v[g])
            outs.append(out)
            dens.append(den)
            dvals.append(torch.where(keep_b, w, torch.zeros_like(w)).T
                         @ g_in[g])
            nz = w != 0
            pairs["needed"] += int(nz.sum())
            pairs["computed_fwd"] += int(keep_f.sum())
            pairs["computed_bwd"] += int(keep_b.sum())
            pairs["dropped"] += int((nz & ~keep_f).sum()
                                    + (nz & ~keep_b).sum())
    pairs["scanned"] = scanned_pairs(slots, q)
    return torch.stack(outs), torch.stack(dens), torch.stack(dvals), pairs


@functools.lru_cache(maxsize=None)
def _kernels():
    """The built library's C entry points (fwd, bwd, setup), argument types
    declared."""
    from .build import load_library

    lib = load_library("softmax_interp")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd = lib.softmax_interp_fwd
    fwd.restype = i
    fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, f, i, p]
    bwd = lib.softmax_interp_bwd
    bwd.restype = i
    bwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, i, p]
    setup = lib.softmax_interp_setup
    setup.restype = i
    setup.argtypes = []
    return fwd, bwd, setup


@functools.lru_cache(maxsize=None)
def _setup(device_index: int) -> None:
    """The backward kernels' shared-memory limits, set once per device."""
    _, _, setup = _kernels()
    with torch.cuda.device(device_index):
        err = setup()
    if err != 0:
        raise RuntimeError(f"softmax_interp set-up failed: cudaError_t {err}")


def _pairs_ptr(pairs, device):
    """The address of a pairs counter (int64 [1] on `device`), or None."""
    if pairs is None:
        return None
    if (pairs.dtype != torch.int64 or pairs.shape != (1,)
            or pairs.device != device):
        raise ValueError(f"pairs must be an int64 [1] tensor on {device}, got "
                         f"{pairs.dtype} {tuple(pairs.shape)} on "
                         f"{pairs.device}")
    return pairs.data_ptr()


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
                       exp_dtype: str = "float32",
                       pairs: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [G, Q, C], den [G, Q]) for queries [Q, 2], db [G, N, 2], vals
    [G, N, C] f32 and the ranges of `scan_slots`.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    on the current stream or raises.  `pairs`, an int64 [1] tensor on the
    card, makes the kernel add the (query, slot) pairs it computes to it.
    """
    _check(queries, db, vals, slots, exp_dtype)
    if db.device.type != "cuda":
        if pairs is not None:
            raise ValueError("pairs counts a kernel's work: CUDA tensors only")
        return softmax_interp_fwd_plain(queries, db, vals, temp, slots,
                                        exp_dtype)
    queries, db, vals, slots = _kernel_args(queries, db, vals, slots)
    g, n, c = vals.shape
    q = queries.shape[0]
    out = torch.empty(g, q, c, dtype=torch.float32, device=db.device)
    den = torch.empty(g, q, dtype=torch.float32, device=db.device)
    count = _pairs_ptr(pairs, db.device)
    fwd, _, _ = _kernels()
    with torch.cuda.device(db.device):
        stream = torch.cuda.current_stream(db.device).cuda_stream
        err = fwd(queries.data_ptr(), db.data_ptr(), vals.data_ptr(),
                  slots.data_ptr(), out.data_ptr(), den.data_ptr(), count, g,
                  q, n, c, slots.shape[1], _prescale(temp),
                  int(exp_dtype == "bfloat16"), stream)
    if err != 0:
        raise RuntimeError(f"softmax_interp_fwd kernel failed: cudaError_t {err}")
    softmax_interp_fwd.launches += 1
    return out, den


def softmax_interp_bwd(queries: torch.Tensor, db: torch.Tensor,
                       gs: torch.Tensor, temp: float, slots: torch.Tensor,
                       exp_dtype: str = "float32",
                       pairs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """d vals [G, N, C] for the scaled cotangent gs [G, Q, C] =
    g_out / max(den, 1e-30).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    on the current stream or raises.  `pairs` as in `softmax_interp_fwd`.
    """
    _check(queries, db, gs, slots, exp_dtype)
    if gs.shape[1] != queries.shape[0]:
        raise ValueError(f"gs must be [G, Q={queries.shape[0]}, C], got "
                         f"{tuple(gs.shape)}")
    if db.device.type != "cuda":
        if pairs is not None:
            raise ValueError("pairs counts a kernel's work: CUDA tensors only")
        return softmax_interp_bwd_plain(queries, db, gs, temp, slots,
                                        exp_dtype)
    queries, db, gs, slots = _kernel_args(queries, db, gs, slots)
    g, q, c = gs.shape
    n = db.shape[1]
    dvals = torch.empty(g, n, c, dtype=torch.float32, device=db.device)
    count = _pairs_ptr(pairs, db.device)
    _, bwd, _ = _kernels()
    _setup(db.device.index)
    with torch.cuda.device(db.device):
        stream = torch.cuda.current_stream(db.device).cuda_stream
        err = bwd(queries.data_ptr(), db.data_ptr(), gs.data_ptr(),
                  slots.data_ptr(), dvals.data_ptr(), count, g, q, n, c,
                  slots.shape[1], _prescale(temp),
                  int(exp_dtype == "bfloat16"), stream)
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

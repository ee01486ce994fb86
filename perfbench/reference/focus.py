"""The focus loss of MotionPriorCMax and the event voxel grid, plain.

  times         t_ref from the caller's generator, then the bin midtimes
  interpolate   the flow LUT on the superpixel grid: the mean over the K
                nearest trajectories at each bin's midtime (knn 'exact'),
                or the banded exponential-kernel interpolation ('softmax')
  warp          each event moved by its LUT cell's flow to t_ref
  iwes          bilinear votes of the warped events (weights: valid, 1 -
                |t - t_ref|, inside the image), per polarity, blurred 3x3
  loss          1 / mean Sobel magnitude (l1) + Charbonnier smoothness

`cfg` is a plain dict of the configuration's loss values (`loss_config`).
Events are [B, M, 6] rows (y, x, t, p, bin, valid), positives first at a
static capacity `npos`.  Gradients reach the trajectories through the
flow values and the warped coordinates only, as in the paper's code: the
neighbour choice, the interpolation weights and the vote weights carry
none.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .nets import matmul_precision

LOSS_DEFAULTS = {
    "num_tref": 1, "num_knn": 32, "smooth_weight": 0.003,
    "lut_superpixel_size": 4, "focus_loss_norm": "l1", "dist_norm": "l2",
    "scale_iwe_by_dt": True, "mask_image_border": True,
    "interpolation_scheme": "mean", "smooth_type": "on_flow_to_tref",
    "knn_method": "exact", "softmax_temp": 25.0, "interp_band_px": 80.0,
    "interp_band_dynamic": False, "interp_band_per_bin": None,
}
# Rows of queries of one KNN distance block: [G, rows, N] f32, ~1 GiB.
KNN_BLOCK_ELEMS = 1 << 28
BQ, BN = 512, 1024   # the interpolation band's query block and slot tile


def loss_config(loss: dict, image_shape, num_bins: int, **extra) -> dict:
    """The loss values of a configuration section with their defaults."""
    cfg = dict(LOSS_DEFAULTS)
    cfg.update({k: v for k, v in loss.items() if k in LOSS_DEFAULTS})
    cfg.update(extra)
    cfg["image_shape"] = tuple(image_shape)
    cfg["num_bins"] = int(num_bins)
    return cfg


def reconstruction_times(num_bins: int, generator: torch.Generator
                         ) -> torch.Tensor:
    t_ref = torch.rand(1, generator=generator)
    edges = torch.linspace(0.0, 1.0, num_bins + 1)
    return torch.cat([t_ref, (edges[:-1] + edges[1:]) / 2.0])


def tile_positions(image_shape, tile: int) -> np.ndarray:
    """[N, 2] (y, x) centre pixel of each tile, row-major."""
    h, w = image_shape
    ys = np.arange(tile // 2, h, tile)
    xs = np.arange(tile // 2, w, tile)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([gy.reshape(-1), gx.reshape(-1)], -1).astype(np.float32)


def lut_points(image_shape, s: int) -> np.ndarray:
    """[Q, 2] (y, x) superpixel centres, row-major."""
    h, w = image_shape
    mid = s / 2.0 - 0.5
    gy, gx = np.meshgrid(np.arange(0, h, s, dtype=np.float32) + mid,
                         np.arange(0, w, s, dtype=np.float32) + mid,
                         indexing="ij")
    return np.stack([gy.reshape(-1), gx.reshape(-1)], -1)


# -- the flow LUT -------------------------------------------------------------

def knn_indices(queries: torch.Tensor, db: torch.Tensor, k: int
                ) -> torch.Tensor:
    """[G, Q, K] indices of the K nearest db points (squared l2 as
    q.q - 2 q.d + d.d in f32, TF32 off), blockwise over the queries."""
    g, n, _ = db.shape
    block = max(1, min(queries.shape[0], KNN_BLOCK_ELEMS // max(g * n, 1)))
    dd = (db * db).sum(-1)[:, None, :]
    out = []
    with matmul_precision("float32"):
        for q0 in range(0, queries.shape[0], block):
            qb = queries[q0:q0 + block]
            dist = ((qb * qb).sum(-1)[None, :, None]
                    - 2.0 * torch.matmul(qb[None], db.transpose(1, 2)) + dd)
            out.append(torch.topk(dist, min(k, n), dim=-1, largest=False,
                                  sorted=True).indices)
    return torch.cat(out, dim=1)


def gather_traj(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values [B, T, N, ...], idx [B, T, Q, K] -> [B, T, Q, K, ...]."""
    b, t, n = values.shape[:3]
    flat = values.reshape(b, t, n, -1)
    q, k = idx.shape[2:]
    out = torch.gather(flat, 2, idx.reshape(b, t, q * k, 1).expand(
        -1, -1, -1, flat.shape[-1]))
    return out.reshape(b, t, q, k, *values.shape[3:])


def band_rows(cfg: dict, grid_points: torch.Tensor, db: torch.Tensor,
              b: int, n_bins: int, wq: int) -> torch.Tensor:
    """[R, 3] (margin px, cell, wq) of the interpolation's row band: a
    margin per group from the trajectories' largest |y displacement|
    ('interp_band_dynamic'), per bin growing from the kernel's tail to
    interp_band_px ('interp_band_per_bin'), else one static margin."""
    s, temp = float(cfg["lut_superpixel_size"]), float(cfg["softmax_temp"])
    dev = db.device
    if cfg["interp_band_dynamic"] and cfg["interp_band_px"] > 0:
        n = db.shape[1]
        if n == grid_points.shape[0]:
            slot_y = grid_points[:, 0]
        else:
            slot_y = (torch.div(torch.arange(n, dtype=torch.float32,
                                             device=dev), wq,
                                rounding_mode="floor") * s + s / 2.0 - 0.5)
        ydisp = (db[..., 0] - slot_y[None]).abs()
        tail = 4.0 * math.sqrt(temp) + s
        margin = (ydisp.amax(dim=1) if cfg["interp_band_dynamic"]
                  == "per_group" else ydisp.amax()[None]) + tail
        return torch.stack([margin, torch.full_like(margin, s),
                            torch.full_like(margin, float(wq))], -1)
    if cfg["interp_band_per_bin"] and cfg["interp_band_px"] > 0:
        tail = 4.0 * math.sqrt(temp)
        mid = (np.arange(n_bins, dtype=np.float32) + 0.5) / n_bins
        mb = np.minimum(tail + (cfg["interp_band_px"] - tail) * mid,
                        cfg["interp_band_px"])
        rows = np.stack([np.tile(mb, b), np.full(b * n_bins, s),
                         np.full(b * n_bins, wq)], -1).astype(np.float32)
        return torch.from_numpy(rows).to(dev)
    return torch.tensor([[float(cfg["interp_band_px"]), s, float(wq)]],
                        device=dev)


def scan_ranges(queries: torch.Tensor, rows: torch.Tensor, groups: int,
                n: int) -> torch.Tensor:
    """int64 [G, ceil(Q / 512), 2]: the slots [lo, hi) each block of 512
    queries scans: the block's rows +- margin as whole grid rows, rounded
    out to tiles of 1024 slots, clipped to N; margin <= 0 scans all."""
    q = queries.shape[0]
    nqb = -(-q // BQ)
    qy = queries[:, 0]
    if nqb * BQ != q:
        qy = torch.cat([qy, qy[-1:].expand(nqb * BQ - q)])
    blocks = qy.reshape(nqb, BQ)
    lo_y = blocks.min(dim=1).values[None]
    hi_y = torch.clamp(blocks.max(dim=1).values, max=1e5)[None]
    margin, cell, wq = rows[:, 0:1], rows[:, 1:2], rows[:, 2:3]
    tiles = float(-(-n // BN))
    t_lo = torch.clamp(torch.floor((lo_y - margin) / cell) * wq / BN, 0.0,
                       tiles).long()
    t_hi = torch.clamp(torch.ceil((torch.floor((hi_y + margin) / cell) + 1.0)
                                  * wq / BN), 0.0, tiles).long()
    use = margin > 0
    t_lo = torch.where(use, t_lo, torch.zeros_like(t_lo))
    t_hi = torch.where(use, t_hi, torch.full_like(t_hi, int(tiles)))
    lo = (t_lo * BN).expand(groups, nqb)
    hi = torch.clamp(t_hi * BN, max=n).expand(groups, nqb)
    return torch.stack([lo, hi], -1)


# Entries of one block of the interpolation's weights, [groups, 512, span].
SOFTMAX_BLOCK_ELEMS = 1 << 28


def _blocks(ranges: torch.Tensor, g: int):
    """(group slice, query block, first slot, end slot) covering the
    scan: per block of 512 queries the span of every group's range, the
    groups in chunks that keep a block's weights within
    SOFTMAX_BLOCK_ELEMS."""
    for qb in range(ranges.shape[1]):
        lo = int(ranges[:, qb, 0].min())
        hi = max(int(ranges[:, qb, 1].max()), lo)
        step = max(1, SOFTMAX_BLOCK_ELEMS // max(BQ * (hi - lo), 1))
        for g0 in range(0, g, step):
            yield slice(g0, g0 + step), qb, lo, hi


def _weights(qs, ds, ranges, gs, qb, lo, hi):
    """[Gs, Qb, span] weights exp2(-|qs - ds|^2) of prescaled points,
    zero outside each group's slot range for this query block."""
    q = qs[qb * BQ:(qb + 1) * BQ]
    d = ds[gs, lo:hi]
    e = -((q[None, :, None, 0] - d[:, None, :, 0]) ** 2
          + (q[None, :, None, 1] - d[:, None, :, 1]) ** 2)
    slot = torch.arange(lo, hi, device=qs.device)[None, None]
    r = ranges[gs, qb]
    keep = (slot >= r[:, None, 0:1]) & (slot < r[:, None, 1:2])
    return torch.where(keep, torch.exp2(e), torch.zeros((), device=qs.device))


class BandedSoftmax(torch.autograd.Function):
    """out[g, q] = sum_n w vals[g, n] / max(sum_n w, 1e-30) over the
    scanned slots, w = exp(-|q - db[g, n]|^2 / temp) (as exp2 of the
    coordinates prescaled by sqrt(log2(e) / temp)); blockwise, the weights
    recomputed in the backward; gradients reach vals only."""

    @staticmethod
    def forward(ctx, queries, db, vals, scale, ranges):
        g, n, c = vals.shape
        out = vals.new_empty(g, queries.shape[0], c)
        den = vals.new_empty(g, queries.shape[0])
        qs, ds = queries * scale, db * scale
        with matmul_precision("float32"):
            for gs, qb, lo, hi in _blocks(ranges, g):
                w = _weights(qs, ds, ranges, gs, qb, lo, hi)
                rows = slice(qb * BQ, (qb + 1) * BQ)
                den[gs, rows] = w.sum(dim=-1)
                out[gs, rows] = torch.bmm(w, vals[gs, lo:hi]) / torch.clamp(
                    den[gs, rows], min=1e-30)[..., None]
        ctx.save_for_backward(queries, db, den, ranges)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g_out):
        queries, db, den, ranges = ctx.saved_tensors
        g, n = db.shape[:2]
        qs, ds = queries * ctx.scale, db * ctx.scale
        gsc = g_out / torch.clamp(den, min=1e-30)[..., None]
        d_vals = g_out.new_zeros(g, n, g_out.shape[-1])
        with matmul_precision("float32"):
            for gs, qb, lo, hi in _blocks(ranges, g):
                w = _weights(qs, ds, ranges, gs, qb, lo, hi)
                d_vals[gs, lo:hi] += torch.bmm(
                    w.transpose(1, 2), gsc[gs, qb * BQ:(qb + 1) * BQ])
        return None, None, d_vals, None, None


def interpolate_flow(cfg: dict, traj_ref: torch.Tensor,
                     traj_mid: torch.Tensor
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(flow LUT [B, nb, Hq, Wq, R, 2], flow to the next bin [B, nb-1, Hq,
    Wq, 1, 2] or None) from positions at t_ref [B, R, N, 2] and at the bin
    midtimes [B, nb, N, 2]."""
    h, w = cfg["image_shape"]
    s = cfg["lut_superpixel_size"]
    hq, wq = -(-h // s), -(-w // s)
    b, nb, n, _ = traj_mid.shape
    r = traj_ref.shape[1]
    points = torch.from_numpy(lut_points(cfg["image_shape"], s)).to(
        traj_mid.device)
    flow_to_ref = traj_ref.permute(0, 2, 1, 3)[:, None] - traj_mid[:, :, :,
                                                                   None]
    want_next = (cfg["smooth_weight"] > 0
                 and cfg["smooth_type"] == "on_flow_to_next")
    db = traj_mid.detach().reshape(b * nb, n, 2).contiguous()
    if cfg["knn_method"] == "softmax":
        values = flow_to_ref.reshape(b, nb, n, r * 2)
        if want_next:
            nxt = traj_mid[:, 1:] - traj_mid[:, :-1]
            values = torch.cat([values, torch.cat(
                [nxt, torch.zeros_like(nxt[:, :1])], dim=1)], dim=-1)
        c = values.shape[-1]
        rows = band_rows(cfg, points, db, b, nb, wq)
        ranges = scan_ranges(points, rows, b * nb, n)
        scale = float(np.sqrt(np.float32(1.4426950408889634)
                              / np.float32(cfg["softmax_temp"])))
        out = BandedSoftmax.apply(points, db, values.reshape(b * nb, n, c),
                                  scale, ranges).reshape(b, nb, hq, wq, c)
        lut = out[..., :r * 2].reshape(b, nb, hq, wq, r, 2)
        nxt = (out[:, :-1, :, :, r * 2:].reshape(b, nb - 1, hq, wq, 1, 2)
               if want_next else None)
        return lut, nxt
    if cfg["knn_method"] != "exact" or cfg["interpolation_scheme"] != "mean":
        raise ValueError("the reference knows knn 'exact' with the mean "
                         "and 'softmax'")
    with torch.no_grad():
        k = min(cfg["num_knn"], n)
        idx = knn_indices(points, db, k).reshape(b, nb, -1, k)
    lut = gather_traj(flow_to_ref, idx).mean(dim=3).reshape(b, nb, hq, wq,
                                                            r, 2)
    nxt = None
    if want_next:
        diff = (traj_mid[:, 1:] - traj_mid[:, :-1])[..., None, :]
        nxt = gather_traj(diff, idx[:, :-1]).mean(dim=3).reshape(
            b, nb - 1, hq, wq, 1, 2)
    return lut, nxt


# -- events -------------------------------------------------------------------

def warp(cfg: dict, events: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Each event plus its LUT cell's flow: [B, R, M, 2] (y, x)."""
    b, m, _ = events.shape
    _, nb, hq, wq, r, _ = lut.shape
    s = cfg["lut_superpixel_size"]
    it = events[..., 4].long().clamp(0, nb - 1)
    iy = torch.floor(events[..., 0] / s).long().clamp(0, hq - 1)
    ix = torch.floor(events[..., 1] / s).long().clamp(0, wq - 1)
    flat = (it * hq + iy) * wq + ix
    table = lut.reshape(b, nb * hq * wq, r * 2)
    diff = torch.gather(table, 1, flat[..., None].expand(-1, -1, r * 2))
    return diff.reshape(b, m, r, 2).permute(0, 2, 1, 3) + events[:, None, :,
                                                                 :2]


def vote(coords: torch.Tensor, weight: torch.Tensor, h: int, w: int
         ) -> torch.Tensor:
    """[B, M, 2] (y, x), [B, M] -> [B, H, W] bilinear votes: floor of the
    coordinate + 1e-6, four corners each masked to the image, coordinates
    clamped to [-3, size + 2] first.  Differentiable in the coordinates."""
    bsz = coords.shape[0]
    y = coords[..., 0].clamp(-3.0, h + 2.0)
    x = coords[..., 1].clamp(-3.0, w + 2.0)
    fly, flx = torch.floor(y.detach() + 1e-6), torch.floor(x.detach() + 1e-6)
    fy, fx = y - fly, x - flx
    y1, x1 = fly.long(), flx.long()
    base = torch.arange(bsz, device=coords.device)[:, None] * h
    out = torch.zeros(bsz * h * w, dtype=torch.float32, device=coords.device)
    for dy, dx, wgt in ((0, 0, (1 - fy) * (1 - fx)), (1, 0, fy * (1 - fx)),
                        (0, 1, (1 - fy) * fx), (1, 1, fy * fx)):
        yy, xx = y1 + dy, x1 + dx
        mask = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = torch.where(mask, (base + yy) * w + xx, torch.zeros_like(yy))
        val = torch.where(mask, wgt * weight, torch.zeros_like(weight))
        out = out.index_add(0, idx.reshape(-1), val.reshape(-1))
    return out.reshape(bsz, h, w)


def _stencil(x: torch.Tensor, taps, dim: int, reflect: bool) -> torch.Tensor:
    n = x.shape[dim]
    if reflect:
        xp = torch.cat([x.narrow(dim, 1, 1), x, x.narrow(dim, n - 2, 1)], dim)
    else:
        z = torch.zeros_like(x.narrow(dim, 0, 1))
        xp = torch.cat([z, x, z], dim)
    return sum(k * xp.narrow(dim, i, n) for i, k in enumerate(taps) if k)


def blur(img: torch.Tensor) -> torch.Tensor:
    """3x3 gaussian (sigma 1), reflect padding."""
    k = np.exp(-0.5 * np.array([-1.0, 0.0, 1.0]) ** 2)
    taps = tuple(float(v) for v in k / k.sum())
    return _stencil(_stencil(img, taps, -2, True), taps, -1, True)


def sobel(img: torch.Tensor):
    gx = _stencil(_stencil(img, (1.0, 2.0, 1.0), -2, False), (-1.0, 0.0, 1.0),
                  -1, False)
    gy = _stencil(_stencil(img, (1.0, 2.0, 1.0), -1, False), (-1.0, 0.0, 1.0),
                  -2, False)
    return gx, gy


def focus_loss(cfg: dict, traj: torch.Tensor, times: torch.Tensor,
               events: torch.Tensor, npos: int) -> torch.Tensor:
    """The loss of trajectories [B, 1 + nb, N, 2] at `times` on the events."""
    h, w = cfg["image_shape"]
    r = cfg["num_tref"]
    t_ref = times[:r].to(traj.device)
    lut, nxt = interpolate_flow(cfg, traj[:, :r], traj[:, r:])
    warped = warp(cfg, events, lut)
    b, _, m, _ = warped.shape
    coords = warped.reshape(b * r, m, 2)
    ev = events[:, None].expand(b, r, m, 6).reshape(b * r, m, 6)
    with torch.no_grad():
        wgt = ev[..., 5]
        if cfg["scale_iwe_by_dt"]:
            wgt = (1.0 - torch.clamp((ev[..., 2] - t_ref.repeat(b)[:, None]
                                      ).abs(), 0.0, 1.0)) * wgt
        if cfg["mask_image_border"]:
            cy, cx = coords[..., 0], coords[..., 1]
            wgt = wgt * ((cy <= h) & (cx <= w) & (cy >= 0) & (cx >= 0)).float()
    iwes = torch.stack([vote(coords[:, :npos], wgt[:, :npos], h, w),
                        vote(coords[:, npos:], wgt[:, npos:], h, w)], dim=1)
    gx, gy = sobel(blur(iwes))
    if cfg["focus_loss_norm"] != "l1":
        raise ValueError("the reference knows focus_loss_norm l1")
    loss = 1.0 / torch.mean(gx.abs() + gy.abs())
    if cfg["smooth_weight"] > 0:
        field = lut if cfg["smooth_type"] == "on_flow_to_tref" else nxt
        ff = field.permute(0, 1, 4, 5, 2, 3)
        ff = ff.reshape(-1, *ff.shape[-3:])
        sx, sy = sobel(ff)
        charb = [torch.mean(torch.sqrt(d * d + 1e-6)) for d in (sx, sy)]
        loss = loss + cfg["smooth_weight"] * (charb[0] + charb[1]) / 2.0
    return loss


def voxel_grid(events: torch.Tensor, num_bins: int, h: int, w: int
               ) -> torch.Tensor:
    """[B, M, 6] events (t in [0, 1]) -> [B, nb, H, W] trilinear votes of
    (2p - 1) valid at t (nb - 1), each axis masked to its range, then per
    sample (x - mean) / std over the nonzero voxels (Bessel's std)."""
    bsz = events.shape[0]
    val = (2.0 * events[..., 3] - 1.0) * events[..., 5]
    y = events[..., 0].clamp(-3.0, h + 2.0)
    x = events[..., 1].clamp(-3.0, w + 2.0)
    t = (events[..., 2] * (num_bins - 1)).clamp(-3.0, num_bins + 2.0)
    x0, y0, t0 = torch.floor(x), torch.floor(y), torch.floor(t)
    base = torch.arange(bsz, device=events.device)[:, None] * num_bins
    out = torch.zeros(bsz * num_bins * h * w, device=events.device)
    for dx in (0.0, 1.0):
        xi = x0 + dx
        for dy in (0.0, 1.0):
            yi = y0 + dy
            for dt in (0.0, 1.0):
                ti = t0 + dt
                mask = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                        & (ti >= 0) & (ti < num_bins))
                wgt = ((1 - (xi - x).abs()) * (1 - (yi - y).abs())
                       * (1 - (ti - t).abs()))
                idx = ((base + ti.long()) * h + yi.long()) * w + xi.long()
                out.index_add_(0, torch.where(mask, idx, 0).reshape(-1),
                               torch.where(mask, val * wgt, 0.0).reshape(-1))
    grids = out.reshape(bsz, num_bins, h, w)
    dims = (1, 2, 3)
    nz = (grids != 0).float()
    cnt = nz.sum(dims, keepdim=True)
    mean = (grids * nz).sum(dims, keepdim=True) / cnt.clamp(min=1.0)
    var = (((grids - mean) ** 2) * nz).sum(dims, keepdim=True) \
        / (cnt - 1.0).clamp(min=1.0)
    std = var.sqrt()
    normed = torch.where(std > 0, (grids - mean) / std, grids - mean)
    return torch.where((cnt > 0) & (nz > 0), normed, grids)


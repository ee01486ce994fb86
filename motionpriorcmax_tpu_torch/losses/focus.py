"""FocusLoss: the motion-prior contrast-maximization objective
(JAX: losses/focus.py).

Per step:
  1. reconstruction times: t_ref, then the bin midpoints
  2. the K nearest trajectories of every superpixel-LUT cell at each bin's
     midtime (`ops/knn.py`: over all of them, or in a spatial-hash window
     with knn_method 'grid' / 'grid_approx'), or with knn_method='softmax'
     the exponential-kernel interpolation (l2: the banded softmax-interp
     kernels; l1: blockwise in plain PyTorch)
  3. per-cell flow to t_ref: mean (or inverse-distance) over the K
  4. per-event flow lookup by (bin, y // s, x // s) and warp: the LUT-gather
     kernels when events arrive cell-sorted (`cell_ends`)
  5. bilinear IWE vote (the IWE-vote kernels), 3x3 gaussian blur
  6. loss = 1 / gradient_magnitude(IWE) + smoothness

Everything is a function of (trajectories, times, events); polarity-aware
batching relies on the collate packing positive events first at a static
capacity (data/collate.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops import events as ev_ops
from ..ops import gradients as grad_ops
from ..device import no_tf32
from ..ops.cuda.softmax_interp import softmax_interp
from ..ops.knn import knn_blocked, knn_grid_window
from ..utils.profiling import scope

EPS = 1e-9
KNN_METHODS = ("exact", "approx", "grid", "grid_approx", "softmax")


@dataclasses.dataclass(frozen=True)
class FocusLossConfig:
    """The JAX config's field names, so YAML files translate unchanged.

    `knn_method` is 'exact' or 'approx' (the K nearest trajectories,
    ops/knn.py; 'approx' is exact, as JAX's lax.approx_min_k is off the
    TPU), 'grid' or 'grid_approx' (the K nearest in the spatial-hash
    window of each LUT cell: cell size = superpixel, grid = (Hq, Wq)), or
    'softmax' (`_softmax_interpolate_flow`).  For softmax with dist_norm
    l2 the fields `softmax_temp`, `interp_band_px`, `interp_band_dynamic`
    False / True / 'per_group', `interp_band_per_bin`, `interp_cross` None
    / 'vpu' / 'mxu' and `interp_exp_dtype` 'float32' / 'bfloat16' act as
    in the JAX package's Pallas branch; `use_pallas_interp` is read and
    ignored: the port always computes the TPU kernel's function, which
    JAX runs only on a TPU by default.  With dist_norm l1 it computes the
    JAX package's blockwise path, which JAX runs on every backend for l1
    (`softmax_interp_l1`: no band, queries in blocks of `knn_block_size`).
    The remaining TPU tiling fields (`iwe_impl`, `vote_band_px`,
    `lut_gather_impl`, `segsum_gather_impl`) have no effect: the vote and
    the sorted LUT gather always run the port's kernels, and the KNN
    bounds its blocks by memory.
    """

    image_shape: Tuple[int, int] = (480, 640)
    num_tref: int = 1
    num_bins: int = 15
    num_knn: int = 32
    smooth_weight: float = 0.003
    lut_superpixel_size: int = 4
    focus_loss_norm: str = "l1"
    dist_norm: str = "l2"
    scale_iwe_by_dt: bool = True
    mask_image_border: bool = True
    polarity_aware_batching: bool = True
    interpolation_scheme: str = "mean"
    smooth_type: str = "on_flow_to_tref"
    loss_type: str = "gradient_magnitude"
    focus_loss_epsilon: float = 0.0
    knn_method: str = "exact"
    is_needing_offsets: bool = True
    # Softmax interpolation and TPU tiling fields (see above).
    knn_block_size: int = 1024
    softmax_temp: float = 25.0
    use_pallas_interp: Optional[bool] = None
    interp_band_px: float = 80.0
    interp_band_dynamic: object = False
    interp_band_per_bin: Optional[bool] = None
    interp_cross: Optional[str] = None
    interp_exp_dtype: str = "float32"
    iwe_impl: Optional[str] = None
    vote_band_px: Optional[int] = None
    lut_gather_impl: Optional[str] = None
    segsum_gather_impl: Optional[str] = None

    def __post_init__(self):
        if self.knn_method not in KNN_METHODS:
            raise ValueError(f"unknown knn_method {self.knn_method!r} "
                             f"({', '.join(KNN_METHODS)})")
        if self.dist_norm not in ("l2", "l1"):
            raise ValueError(f"unknown dist_norm {self.dist_norm!r}")
        if (isinstance(self.interp_band_dynamic, str)
                and self.interp_band_dynamic != "per_group"):
            raise ValueError(
                "interp_band_dynamic must be False, True or 'per_group', got "
                f"{self.interp_band_dynamic!r}")
        if self.interp_cross not in (None, "vpu", "mxu"):
            raise ValueError("interp_cross must be 'vpu', 'mxu' or None, got "
                             f"{self.interp_cross!r}")
        if self.interp_exp_dtype not in ("float32", "bfloat16"):
            raise ValueError("interp_exp_dtype must be 'float32' or "
                             f"'bfloat16', got {self.interp_exp_dtype!r}")
        if self.scale_iwe_by_dt and self.num_tref != 1:
            raise ValueError("scale_iwe_by_dt needs num_tref == 1")
        if self.polarity_aware_batching and self.num_tref != 1:
            raise ValueError("polarity_aware_batching needs num_tref == 1")
        if self.smooth_type == "on_flow_to_next" and self.num_tref != 1:
            raise ValueError("smooth_type on_flow_to_next needs num_tref == 1")


def get_reconstruction_times(cfg: FocusLossConfig,
                             generator: Optional[torch.Generator] = None,
                             device=None) -> torch.Tensor:
    """[num_tref + num_bins] f32: t_ref (uniform from `generator` when
    num_tref == 1, else linspace) followed by the bin midpoints."""
    if cfg.num_tref > 1:
        t_ref = torch.linspace(0.0, 1.0, cfg.num_tref)
    elif cfg.num_tref == 1:
        t_ref = torch.rand(1, generator=generator)
    else:
        raise ValueError("num_tref must be >= 1")
    edges = torch.linspace(0.0, 1.0, cfg.num_bins + 1)
    t_mid = (edges[:-1] + edges[1:]) / 2.0
    return torch.cat([t_ref, t_mid]).to(device)


def lut_grid_points(cfg: FocusLossConfig) -> np.ndarray:
    """[Q, 2] f32 (y, x) superpixel centres, row-major."""
    h, w = cfg.image_shape
    s = cfg.lut_superpixel_size
    mid = float(s) / 2.0 - 0.5
    ys = np.arange(0, h, s, dtype=np.float32) + mid
    xs = np.arange(0, w, s, dtype=np.float32) + mid
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([gy.reshape(-1), gx.reshape(-1)], axis=-1)


def _gather_traj(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values [B, T, N, ...], idx [B, T, Q, K] -> [B, T, Q, K, ...]."""
    b, t, n = values.shape[:3]
    rest = values.shape[3:]
    flat = values.reshape(b, t, n, -1)
    q, k = idx.shape[2:]
    out = torch.gather(flat, 2, idx.reshape(b, t, q * k, 1).expand(
        -1, -1, -1, flat.shape[-1]))
    return out.reshape(b, t, q, k, *rest)


def interpolate_flow(cfg: FocusLossConfig, traj_at_tref: torch.Tensor,
                     traj_at_tmid: torch.Tensor
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-bin flow LUT on the superpixel grid.

    Args:
      traj_at_tref: [B, n_tref, N, 2] positions at the reference times.
      traj_at_tmid: [B, n_bins, N, 2] positions at the bin midtimes.

    Returns:
      flow_lut [B, n_bins, Hq, Wq, n_tref, 2] (displacement to each t_ref)
      and flow_to_next [B, n_bins-1, Hq, Wq, 1, 2] or None.
    """
    h, w = cfg.image_shape
    s = cfg.lut_superpixel_size
    hq, wq = -(-h // s), -(-w // s)
    b, n_bins, n, _ = traj_at_tmid.shape
    grid_points = torch.from_numpy(lut_grid_points(cfg)).to(
        traj_at_tmid.device)
    if cfg.knn_method == "softmax":
        return _softmax_interpolate_flow(cfg, grid_points, traj_at_tref,
                                         traj_at_tmid, hq, wq)

    # KNN per (batch, bin), on positions without gradient (the indices are
    # integers; the reference's KeOps argKmin).
    windowed = cfg.knn_method.startswith("grid")
    db = traj_at_tmid.detach().reshape(b * n_bins, n, 2)
    with torch.no_grad(), scope("loss.knn"):
        if windowed:
            idx, dist = knn_grid_window(
                grid_points, db, cfg.num_knn, norm=cfg.dist_norm,
                cell_size=float(s), grid_hw=(hq, wq),
                method="approx" if cfg.knn_method.endswith("approx")
                else "exact")
        else:
            idx, dist = knn_blocked(grid_points, db, cfg.num_knn,
                                    norm=cfg.dist_norm,
                                    method=cfg.knn_method)
    k = idx.shape[-1]
    idx = idx.reshape(b, n_bins, -1, k)
    dist = dist.reshape(b, n_bins, -1, k)

    # flow_to_tref[b, t, n, r, :] = traj_ref[b, r, n, :] - traj_mid[b, t, n, :]
    flow_to_tref = (traj_at_tref.permute(0, 2, 1, 3)[:, None]
                    - traj_at_tmid[:, :, :, None, :])
    flow_k = _gather_traj(flow_to_tref, idx)      # [B, T, Q, K, n_tref, 2]
    if k == 1 or cfg.interpolation_scheme == "mean":
        if windowed:
            # The window's empty slots (+inf distance) take no part.
            fmask = torch.isfinite(dist)[..., None, None].to(flow_k.dtype)
            flow_q = (flow_k * fmask).sum(dim=3) / torch.clamp(
                fmask.sum(dim=3), min=1.0)
        else:
            flow_q = flow_k.sum(dim=3) / float(k)
    elif cfg.interpolation_scheme == "iwd":
        # 1 / (inf + EPS) = 0: the window's empty slots weigh nothing.
        dw = 1.0 / (dist + EPS)
        dw = dw / torch.clamp(dw.sum(dim=3, keepdim=True), min=EPS)
        flow_q = torch.sum(dw[..., None, None] * flow_k, dim=3)
    else:
        raise ValueError(
            f"unknown interpolation_scheme {cfg.interpolation_scheme!r}")
    flow_lut = flow_q.reshape(b, n_bins, hq, wq, *flow_q.shape[-2:])

    flow_to_next = None
    if cfg.smooth_weight > 0 and cfg.smooth_type == "on_flow_to_next":
        diff_next = (traj_at_tmid[:, 1:] - traj_at_tmid[:, :-1])[..., None, :]
        fn_k = _gather_traj(diff_next, idx[:, :-1])
        flow_to_next = fn_k.mean(dim=3).reshape(b, n_bins - 1, hq, wq, 1, 2)
    return flow_lut, flow_to_next


def interp_band(cfg: FocusLossConfig, grid_points: torch.Tensor,
                db: torch.Tensor, b: int, n_bins: int, wq: int):
    """The softmax interpolation's row band (JAX focus.py:345-379):

    - `interp_band_dynamic` (with interp_band_px > 0): margin = the largest
      |y displacement| of the db points from their nominal grid rows, plus
      4 sqrt(temp) + cell; True shares one margin, 'per_group' gives each
      (batch, bin) group its own.  Computed on the device, no host sync.
    - `interp_band_per_bin`: bin b's margin is tail + (interp_band_px -
      tail) * t_mid_b (tail = 4 sqrt(temp)), sound for trajectories whose
      displacement grows linearly from t = 0.
    - else the static (interp_band_px, cell, wq); a margin <= 0 scans all.
    """
    s = float(cfg.lut_superpixel_size)
    temp = cfg.softmax_temp
    n = db.shape[1]
    if cfg.interp_band_dynamic and cfg.interp_band_px > 0:
        if n == grid_points.shape[0]:
            slot_y = grid_points[:, 0]
        else:
            slot_y = torch.div(torch.arange(n, dtype=torch.float32,
                                            device=db.device), wq,
                               rounding_mode="floor") * s + s / 2.0 - 0.5
        tail = 4.0 * float(np.sqrt(temp)) + s
        ydisp = torch.abs(db[..., 0] - slot_y[None, :]).detach()     # [G, N]
        if cfg.interp_band_dynamic == "per_group":
            margin = ydisp.amax(dim=1) + tail                        # [G]
        else:
            margin = ydisp.amax()[None] + tail                       # [1]
        return torch.stack([margin, torch.full_like(margin, s),
                            torch.full_like(margin, float(wq))], dim=-1)
    if cfg.interp_band_per_bin and cfg.interp_band_px > 0:
        margin = float(cfg.interp_band_px)
        tail = 4.0 * float(np.sqrt(temp))
        t_mid = (np.arange(n_bins, dtype=np.float32) + 0.5) / n_bins
        mb = np.minimum(tail + (margin - tail) * t_mid, margin)
        rows = np.stack([np.tile(mb, b), np.full(b * n_bins, s, np.float32),
                         np.full(b * n_bins, wq, np.float32)], axis=-1)
        return torch.from_numpy(rows.astype(np.float32)).to(db.device)
    return (float(cfg.interp_band_px), s, float(wq))


def _softmax_interpolate_flow(cfg: FocusLossConfig, grid_points: torch.Tensor,
                              traj_at_tref: torch.Tensor,
                              traj_at_tmid: torch.Tensor, hq: int, wq: int
                              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Flow LUT as a banded exponential-kernel interpolation (the JAX Pallas
    branch, focus.py:301-396): per (batch, bin) group,

        out[q] = sum_n softmax_n(-|q - traj_at_tmid[n]|^2 / temp) value[n]

    over the band's scanned trajectories, with value = flow to each t_ref
    (plus flow to the next bin with smooth_type 'on_flow_to_next').  The
    weights carry no gradient (db is detached): gradients reach the
    trajectories through the values only.
    """
    b, n_bins, n, _ = traj_at_tmid.shape
    n_tref = traj_at_tref.shape[1]
    flow_to_tref = (traj_at_tref.permute(0, 2, 1, 3)[:, None]
                    - traj_at_tmid[:, :, :, None, :])     # [B, T, N, R, 2]
    values = flow_to_tref.reshape(b, n_bins, n, n_tref * 2)
    want_next = cfg.smooth_weight > 0 and cfg.smooth_type == "on_flow_to_next"
    if want_next:
        diff_next = traj_at_tmid[:, 1:] - traj_at_tmid[:, :-1]
        # The last bin has no next bin: zeros, discarded below.
        values = torch.cat([values, torch.cat(
            [diff_next, torch.zeros_like(diff_next[:, :1])], dim=1)], dim=-1)
    c = values.shape[-1]
    db = traj_at_tmid.detach().reshape(b * n_bins, n, 2).contiguous()
    vals = values.reshape(b * n_bins, n, c).contiguous()
    if cfg.dist_norm == "l1":
        out = softmax_interp_l1(grid_points, db, vals,
                                float(cfg.softmax_temp), cfg.knn_block_size)
    else:
        out = softmax_interp(
            grid_points, db, vals, float(cfg.softmax_temp),
            interp_band(cfg, grid_points, db, b, n_bins, wq),
            cfg.interp_exp_dtype, cfg.interp_cross or "vpu")
    out = out.reshape(b, n_bins, hq, wq, c)
    flow_lut = out[..., :n_tref * 2].reshape(b, n_bins, hq, wq, n_tref, 2)
    flow_to_next = None
    if want_next:
        flow_to_next = out[:, :-1, :, :, n_tref * 2:].reshape(
            b, n_bins - 1, hq, wq, 1, 2)
    return flow_lut, flow_to_next


# Weight entries per block of softmax_interp_l1: [groups, queries, N] f32,
# 256 MiB.
L1_BLOCK_ELEMS = 1 << 26


def _l1_weights(qb: torch.Tensor, db: torch.Tensor, temp: float
                ) -> torch.Tensor:
    """[Gb, Qb, N] f32 weights exp(-(d - min_n d) / temp) of the L1
    distances d of queries qb [Qb, 2] to db [Gb, N, 2], the exponent
    rounded to bf16 (JAX focus.py:423-432).

    JAX writes exp(z.astype(bf16)).astype(f32), but XLA keeps the exp's
    f32 result (excess precision, its default): the weights it computes
    are the f32 exp of the rounded exponent, within an f32 ulp of these;
    a bf16 result would differ from them by up to 0.4%."""
    dist = (qb[None, :, None, 0] - db[:, None, :, 0]).abs_()
    dist += (qb[None, :, None, 1] - db[:, None, :, 1]).abs_()
    # -(d - min) / temp, in place: (d - min) / -temp has the same bits.
    z = dist.sub_(dist.amin(dim=-1, keepdim=True)).div_(-temp)
    return z.to(torch.bfloat16).to(torch.float32).exp_()


def _l1_blocks(g: int, q: int, n: int, block_size: int):
    """(group slice, query slice) pairs covering [G, Q]: queries in blocks
    of at most `block_size`, groups so that a block's weights stay within
    L1_BLOCK_ELEMS."""
    qb = max(1, min(block_size, q))
    gb = max(1, L1_BLOCK_ELEMS // max(qb * n, 1))
    for g0 in range(0, g, gb):
        for q0 in range(0, q, qb):
            yield slice(g0, g0 + gb), slice(q0, q0 + qb)


class _SoftmaxInterpL1(torch.autograd.Function):
    """out = (a @ vals) / sum_n a per query block, a from `_l1_weights`;
    the weights carry no gradient and are recomputed in the backward."""

    @staticmethod
    def forward(ctx, queries, db, vals, temp, block_size):
        g, n, c = vals.shape
        q = queries.shape[0]
        out = vals.new_empty(g, q, c)
        den = vals.new_empty(g, q, 1)
        with no_tf32():
            for gs, qs in _l1_blocks(g, q, n, block_size):
                a = _l1_weights(queries[qs], db[gs], temp)
                den[gs, qs] = a.sum(dim=-1, keepdim=True)
                out[gs, qs] = torch.bmm(a, vals[gs]) / den[gs, qs]
        ctx.save_for_backward(queries, db, den)
        ctx.temp, ctx.block_size, ctx.shape = temp, block_size, (g, n, c)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        queries, db, den = ctx.saved_tensors
        g, n, c = ctx.shape
        d_vals = grad_out.new_zeros(g, n, c)
        with no_tf32():
            for gs, qs in _l1_blocks(g, queries.shape[0], n, ctx.block_size):
                a = _l1_weights(queries[qs], db[gs], ctx.temp)
                d_vals[gs] += torch.bmm(a.transpose(1, 2),
                                        grad_out[gs, qs] / den[gs, qs])
        return None, None, d_vals, None, None


def softmax_interp_l1(queries: torch.Tensor, db: torch.Tensor,
                      vals: torch.Tensor, temp: float, block_size: int = 1024
                      ) -> torch.Tensor:
    """The exponential-kernel interpolation with L1 distances (JAX:
    losses/focus.py:398-441, the blockwise path, which JAX runs for
    dist_norm l1 on every backend): per group g and query q,

        a[n] = exp(bf16(-(|q - db[g, n]|_1 - min_n |q - db[g, n]|_1) / temp))
        (the exp in f32 of the bf16-rounded exponent, see `_l1_weights`)
        out[g, q] = sum_n a[n] vals[g, n] / sum_n a[n]

    over all N points (no band), the value product and the normalization
    in f32.  Plain PyTorch in blocks of `block_size` queries (not a kernel
    row: JAX's Pallas kernel is l2 only).  Gradients reach `vals` only.

    Args:
      queries: [Q, 2]; db: [G, N, 2]; vals: [G, N, C].

    Returns:
      [G, Q, C] f32.
    """
    return _SoftmaxInterpL1.apply(queries, db.detach(), vals, float(temp),
                                  int(block_size))


def lut_indices(cfg: FocusLossConfig, events: torch.Tensor, n_bins: int,
                sorted_layout: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 [B, M] LUT (row, col) of each event.

    sorted_layout: rows are y-major (y // s) * n_bins + bin over a
    [Hq * n_bins, Wq] LUT, the order of data/host_ops.py::lut_cell_keys;
    else bin-major bin * Hq + y // s over [n_bins * Hq, Wq].
    """
    h, w = cfg.image_shape
    s = cfg.lut_superpixel_size
    hq, wq = -(-h // s), -(-w // s)
    it = events[..., ev_ops.BIN].long()
    iy = torch.floor(events[..., ev_ops.Y] / s).long()
    ix = torch.floor(events[..., ev_ops.X] / s).long()
    cols = ix.clamp(0, wq - 1)
    if sorted_layout:
        rows = iy.clamp(0, hq - 1) * n_bins + it.clamp(0, n_bins - 1)
    else:
        rows = (it * hq + iy).clamp(0, n_bins * hq - 1)
    return rows.to(torch.int32), cols.to(torch.int32)


def warp_events(cfg: FocusLossConfig, events: torch.Tensor,
                flow_lut: torch.Tensor,
                cell_ends: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Warp every event by its LUT cell's flow to each reference time.

    Args:
      events: [B, M, 6] rows (y, x, t, p, bin, valid).
      flow_lut: [B, n_bins, Hq, Wq, n_tref, 2].
      cell_ends: [B, S * n_bins * Hq * Wq] int32 boundaries of the events'
        runs of equal LUT cell (events cell-sorted per polarity segment,
        data/host_ops.py::lut_cell_sort): the lookup and its backward then
        run the LUT-gather kernels.  None takes plain indexing.

    Returns:
      warped (y, x) [B, n_tref, M, 2] (the JAX function also carries the
      unchanged t, p, bin, valid columns; `make_iwes` reads them from the
      events instead).
    """
    b, m, _ = events.shape
    _, n_bins, hq, wq, n_tref, _ = flow_lut.shape
    sorted_layout = cell_ends is not None
    rows, cols = lut_indices(cfg, events, n_bins, sorted_layout)
    if sorted_layout:
        lut_grid = flow_lut.permute(0, 2, 1, 3, 4, 5).reshape(
            b, hq * n_bins, wq, n_tref * 2)
    else:
        lut_grid = flow_lut.reshape(b, n_bins * hq, wq, n_tref * 2)
    differences = ev_ops.grid_gather(lut_grid.contiguous(), rows, cols,
                                     cell_ends)
    differences = differences.reshape(b, m, n_tref, 2).permute(0, 2, 1, 3)
    return differences + events[:, None, :, :2]


def make_iwes(cfg: FocusLossConfig, warped_yx: torch.Tensor,
              events: torch.Tensor, t_ref: torch.Tensor,
              num_pos_events: int, mesh=None) -> torch.Tensor:
    """IWEs of the warped events with validity / dt / border weights.

    Returns [B*n_tref, H, W] or, with polarity-aware batching,
    [B*n_tref, 2, H, W] (positive / negative planes), blurred 3x3 (sigma 1).
    With a mesh, `events` are this rank's event shard (positives first,
    `num_pos_events` of them) and the partial votes are summed over the
    event axis before the blur.
    """
    h, w = cfg.image_shape
    b, n_tref, m, _ = warped_yx.shape
    coords = warped_yx.reshape(b * n_tref, m, 2).contiguous()
    ev = events[:, None].expand(b, n_tref, m, 6).reshape(b * n_tref, m, 6)

    # The weights carry no gradient (the reference computes them under
    # torch.no_grad()).
    with torch.no_grad():
        weights = ev[..., ev_ops.VALID]
        if cfg.scale_iwe_by_dt:
            dt = torch.clamp((ev[..., ev_ops.T] - t_ref.repeat(b)[:, None]
                              ).abs(), 0.0, 1.0)
            weights = (1.0 - dt) * weights
        if cfg.mask_image_border:
            cy, cx = coords[..., 0], coords[..., 1]
            inb = (cy <= h) & (cx <= w) & (cy >= 0) & (cx >= 0)
            weights = weights * inb.to(weights.dtype)
        weights = weights.contiguous()

    def vote(c, wgt):
        return ev_ops.iwe_bilinear_vote_batch(c, wgt, height=h, width=w)

    if cfg.polarity_aware_batching:
        if num_pos_events < 0:
            raise ValueError("polarity_aware_batching needs num_pos_events")
        pos = vote(coords[:, :num_pos_events], weights[:, :num_pos_events])
        neg = vote(coords[:, num_pos_events:], weights[:, num_pos_events:])
        iwes = torch.stack([pos, neg], dim=1)
    else:
        iwes = vote(coords, weights)
    if mesh is not None:
        iwes = mesh.event_sum(iwes)
    return ev_ops.gaussian_blur_3x3(iwes, sigma=1.0)


def calculate_smooth_loss(cfg: FocusLossConfig, flow_lut: torch.Tensor,
                          flow_to_next: Optional[torch.Tensor], mesh=None
                          ) -> torch.Tensor:
    """Charbonnier smoothness of the selected flow field (with a mesh, its
    mean over the global batch)."""
    if cfg.smooth_weight == 0:
        return torch.zeros((), dtype=flow_lut.dtype, device=flow_lut.device)
    if cfg.smooth_type == "on_flow_to_tref":
        field = flow_lut
    elif cfg.smooth_type == "on_flow_to_next":
        field = flow_to_next
    else:
        raise ValueError(f"unknown smooth_type {cfg.smooth_type!r}")
    # [B, T, Hq, Wq, R, 2] -> [B*T*R, 2, Hq, Wq]
    ff = field.permute(0, 1, 4, 5, 2, 3)
    c, hq, wq = ff.shape[-3:]
    return cfg.smooth_weight * grad_ops.smoothness_loss(
        ff.reshape(-1, c, hq, wq), mesh)


def focus_loss(cfg: FocusLossConfig, trajectories: torch.Tensor,
               times: torch.Tensor, events: torch.Tensor,
               num_pos_events: int = -1,
               cell_ends: Optional[torch.Tensor] = None, mesh=None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                          Dict[str, torch.Tensor]]:
    """Focus + smoothness loss.

    Args:
      trajectories: [B, num_tref + num_bins, N, 2] absolute positions.
      times: [num_tref + num_bins] from `get_reconstruction_times`.
      events: [B, M, 6], positives packed first with polarity-aware batching.
      num_pos_events: static positive capacity per sample.
      cell_ends: host-computed LUT-cell boundaries of cell-sorted events.
      mesh: a parallel.Mesh, or None on one device.  Given one, the
        arguments are this rank's share of the global batch
        (parallel.shard_batch): its data rank's samples, their events cut
        to its event shard with `cell_ends` clipped to it, while
        `num_pos_events` stays the global capacity.  The partial IWEs are
        summed over the event axis, and the objective's and the
        smoothness term's means are taken over the global batch, so the
        loss is the single-device loss of the global batch on every rank.

    Returns:
      (loss, log metadata, misc metadata with the detached IWEs
      [B, n_tref, (2,) H, W]).
    """
    if cfg.polarity_aware_batching and num_pos_events < 0:
        raise ValueError("polarity_aware_batching needs num_pos_events")
    with scope("loss.forward"):
        t_ref = times[:cfg.num_tref]
        with scope("loss.interpolate"):
            flow_lut, flow_to_next = interpolate_flow(
                cfg, trajectories[:, :cfg.num_tref],
                trajectories[:, cfg.num_tref:])
        with scope("loss.warp"):
            warped = warp_events(cfg, events, flow_lut, cell_ends)
        npos = num_pos_events if mesh is None else \
            mesh.local_capacity(num_pos_events)
        with scope("loss.vote"):
            iwes = make_iwes(cfg, warped, events, t_ref, npos, mesh)
        with scope("loss.objective"):
            focus = grad_ops.focus_objective(iwes, loss_type=cfg.loss_type,
                                             norm=cfg.focus_loss_norm,
                                             epsilon=cfg.focus_loss_epsilon,
                                             mesh=mesh)
        with scope("loss.smooth"):
            smooth = calculate_smooth_loss(cfg, flow_lut, flow_to_next, mesh)
        loss = focus + smooth

    h, w = cfg.image_shape
    b, n_tref = warped.shape[:2]
    shape = (b, n_tref, 2, h, w) if cfg.polarity_aware_batching else \
        (b, n_tref, h, w)
    log_metadata = {"focus_loss": focus.detach(),
                    "smoothness_loss": smooth.detach()}
    misc_metadata = {"iwes": iwes.detach().reshape(shape)}
    return loss, log_metadata, misc_metadata

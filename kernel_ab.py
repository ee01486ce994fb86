"""Time kernels of two or more checkouts of the PyTorch port on one card,
under the same timers, in one call: the corr-window lookup (kernel row 1),
the voxel vote (kernel row 8), the IWE vote's forward and backward (rows 3
and 4), the LUT gather's two backwards (rows 6 and 5), the softmax
interpolation (row 7), the exact KNN (`knn_blocked`: the fused distance +
top-K kernel, or distance blocks and torch.topk before it) and flax's
BatchNorm (+ ReLU) layer (its kernels, or the f32 PyTorch chain before
them).

    python3 kernel_ab.py parent=path/to/other/checkout change=. \
        --order parent,change,change,parent

Each run is a process of its own that imports `motionpriorcmax_tpu_torch`
from its checkout (and builds that checkout's `corr_window.cu`,
`voxel_vote.cu`, `iwe_vote.cu`, `lut_gather.cu`, `segment_sum.cu` and
`softmax_interp.cu` there) and card_cases.py from this script's own
directory (a copy of this script needs that module beside it), makes the
same inputs from a seed on the card, holds every kernel result against its
plain version, and times, with the L2 flushed before each call, these
sections:

  lookup       one refinement iteration of the B=8 EVIMO2 traj-val path:
               `CorrPyramidLookup` over the four pyramid levels, f32, as
               `lookup_corr_pyramid` calls it (the launches it makes are
               counted), and level 1 alone;
  voxel_vote   B=14, M=2^20, 15 x 480 x 640: 1,000,000 events per sample,
               positives then negatives then padding; "sorted": each
               polarity half stable-sorted by 4 x 4-pixel cell (a stand-in
               for the loader's LUT-cell sort), "unsorted": the same events
               in random order, "skewed": half the live events of each
               sample in one 16 x 64 region, 1% on one pixel;
  segsum       `lut_segsum_bwd` (kernel row 6, the LUT gather's sorted
               backward) on card_cases.segsum_cases: "sorted" (phase 8's
               cell-sorted batch, the flow path's), "skewed" (its samples
               through skewed_events, sorted again by the loader's
               LUT-cell sort) and "traj" (the traj-train shape, 2^18
               padding rows per half); fails the run above TOL_SEGSUM or
               when two calls differ in a bit;
  segment_sum  `grid_segment_sum` (row 5, the any-order backward) on
               card_cases.segment_sum_cases: "path" (phase 8's samples
               collated unsorted), "skewed" (in time order) and "traj";
               fails the run above TOL_SEGMENT_SUM;
  iwe_vote     `iwe_vote_fwd` on one polarity half of
               card_cases.vote_batch (B=14, M=2^19, 480 x 640, the loader's
               LUT-cell sort), through `card_cases.vote_cases`: "sorted",
               "unsorted" (random order), "skewed" (a hot pixel and a hot
               16 x 64 region, sorted again) and "wide" (the flow x 6, up
               to 48 px); its error is relative to max(1, max |plain|)
               and fails the run above card_cases.TOL_VOTE_FWD,
               and "band_share" is the share of live taps that the
               forward's plain twin votes through its shared-memory band
               (null for a checkout without the twin);
  iwe_vote_bwd `iwe_vote_bwd` (d coords only, as the focus loss asks) on
               the same four cases for a seeded random image cotangent,
               and "unsorted_strided": the unsorted case with the
               cotangent passed as the path passes it, `select(1, 0)` of
               a [B, 2, H, W] tensor (a batch stride of 2 H W); fails
               the run above card_cases.TOL_VOTE_BWD (relative to
               max(1, max |plain|)) or when two calls differ in a bit;
               "digest" as in `softmax`, of d coords;
  softmax      `softmax_interp_fwd` and `softmax_interp_bwd` on
               card_cases.softmax_cases: "flow" (the flow-train softmax
               step's G=210, Q=N=19,200, C=2, per-bin band, 1% far
               trajectories) and "traj" (the traj-train softmax step's
               G=246, Q=N=12,288, C=4, per-group dynamic band); each
               kernel against its plain version on three groups (fails
               above card_cases.TOL_SOFTMAX, relative to max(1,
               max |plain|)), the backward twice (fails when the two
               calls differ in a bit), and "digest", the SHA-1 of the
               bytes of out, den and d vals with -0 made +0: equal digests
               in two runs mean equal values, bit for bit, up to the sign
               of a zero;
  knn          `ops/knn.py::knn_blocked` as the focus loss calls it
               (K=32, l2) on card_cases.knn_case's databases: "flow_*"
               (the flow-training step's G=210, Q=N=19,200) and "traj_*"
               (the traj-train step's G=246, Q=N=12,288), each in the
               loss's order ("_ordered"), shuffled ("_shuffled") and with
               a flow ten times as large ("_wide"); a checkout before
               the fused kernel (csrc/knn_topk.cu) runs distance blocks
               and torch.topk there, the yardstick; "digest" of the
               indices and distances (the two ways may break ties at the
               K-th value differently);
  flax_bn      one train-mode forward and backward of
               `models/norm.py::FlaxBatchNorm2d` as the checkout has it
               (the ReLU fused where it takes `relu`, else nn.ReLU after
               it) at card_cases.FLAX_BN_SHAPES (each of the UNet's
               norm shapes at B=14, bf16, and of RAFT-Spline's context
               encoder at B=6, f32), and "unet_step", the sums over the
               UNet's 18 norms of one B=14 step; a checkout before the
               kernels (csrc/flax_batch_norm.cu) runs the f32 PyTorch
               chain and autograd there.

`--sections softmax,lookup` runs only those sections (default: all).

Each call is timed by `card_cases.timers`, over 20 calls (10 in
`softmax`, 5 in `knn`): ms (CUDA events around the call, the host's
enqueue in it where that outlasts the L2 flush), card_ms (the card's time
alone) and host_us (the Python call's wall time), the yardstick of
chip_smoke.py's kernels line too.

Prints one JSON line per run ({"run": label, "tree": path, ...}) and then a
table of every run's numbers.

    python3 kernel_ab.py --staging

instead times level 1 of that lookup (f32, B=8) with its windows staged two
ways, in this checkout: the port's kernel (4-byte cp.async copies) and
tools/corr_window_tma.cu (one tensor-map load per window, TMA), each held
against the plain version, and prints one JSON line.

Needs one CUDA card; exits non-zero without.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import functools

from card_cases import (BATCH, FLAX_BN_SHAPES, H, KNN_K, KNN_PATHS,
                        KNN_VARIANTS, LEVELS, Q, RADIUS, TOL_SEGMENT_SUM,
                        TOL_SEGSUM, TOL_SOFTMAX, TOL_VOTE_BWD, TOL_VOTE_FWD,
                        W, flax_bn_inputs, knn_case, level_inputs,
                        nvidia_smi_line, segment_sum_cases, segsum_cases,
                        softmax_cases, softmax_loss_cfgs, timers,
                        vote_band_share, vote_batch, vote_cases)

VOX_B, VOX_M, VOX_LIVE, VOX_NB, VOX_H, VOX_W = 14, 1 << 20, 1_000_000, 15, 480, 640
CELL = 4


def run_lookup(torch, flush):
    from motionpriorcmax_tpu_torch.ops.cuda import corr_window as cw

    tensors = []
    for lvl, (t, h2, w2) in enumerate(LEVELS):
        tensors.extend(level_inputs(torch, t, h2, w2, lvl, 200 + lvl,
                                    torch.float32))
    k = (2 * RADIUS + 1) ** 2
    want = torch.empty(BATCH, sum(t for t, _, _ in LEVELS) * k, H // 8, W // 8,
                       device="cuda")
    off = 0
    for i, (t, _, _) in enumerate(LEVELS):
        corr, cx, cy = tensors[3 * i:3 * i + 3]
        cw.corr_window_lookup_plain(corr, cx, cy, RADIUS, want, off)
        off += t * k

    def pyramid():
        with torch.no_grad():
            return cw.CorrPyramidLookup.apply(RADIUS, H // 8, W // 8, *tensors)

    before = cw.corr_window_lookup.launches
    got = pyramid()
    torch.cuda.synchronize()
    launches = cw.corr_window_lookup.launches - before
    err = float((got - want).abs().max())
    ms, card_ms, host_us = timers(torch, pyramid, flush)
    out1 = torch.empty(BATCH, LEVELS[0][0] * k, H // 8, W // 8, device="cuda")
    l1 = timers(torch, lambda: cw.corr_window_lookup(
        *tensors[:3], RADIUS, out1, 0), flush)
    return {"launches_per_iteration": launches, "max_abs_err": err,
            "ms": ms, "card_ms": card_ms, "host_us": host_us,
            "level1_ms": l1[0], "level1_card_ms": l1[1],
            "level1_host_us": l1[2]}


def vote_batches(torch):
    """(sorted, unsorted, skewed) [B, M, 6] event batches on the card."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    b, m, n = VOX_B, VOX_M, VOX_LIVE
    u = lambda *s: torch.rand(*s, device=dev, generator=g)  # noqa: E731
    ev = torch.zeros(b, m, 6, device=dev)
    ev[:, :n, 0] = u(b, n) * VOX_H
    ev[:, :n, 1] = u(b, n) * VOX_W
    ev[:, :n, 2] = u(b, n)
    ev[:, :n, 3] = (u(b, n) < 0.5).float()
    ev[:, :n, 5] = 1.0
    # Positives first, then negatives, then padding; each half by cell.
    cell = ((ev[..., 0] // CELL) * (VOX_W // CELL) + ev[..., 1] // CELL)
    key = torch.where(ev[..., 5] > 0, (1 - ev[..., 3]) * 1e6 + cell,
                      torch.full_like(cell, 3e6))
    order = torch.sort(key, dim=1, stable=True).indices
    srt = torch.gather(ev, 1, order[..., None].expand(-1, -1, 6))
    perm = torch.argsort(u(b, m), dim=1)
    unsorted = torch.gather(srt, 1, perm[..., None].expand(-1, -1, 6))
    skewed = unsorted.clone()
    y0 = (u(b) * (VOX_H - 16)).floor()
    x0 = (u(b) * (VOX_W - 64)).floor()
    half = n // 2
    live = torch.argsort(u(b, m) + (unsorted[..., 5] == 0) * 2, dim=1)[:, :half]
    rows = torch.arange(b, device=dev)[:, None]
    skewed[rows, live, 0] = y0[:, None] + u(b, half) * 16
    skewed[rows, live, 1] = x0[:, None] + u(b, half) * 64
    hot = live[:, :n // 100]
    skewed[rows, hot, 0] = y0[:, None] + 7.5
    skewed[rows, hot, 1] = x0[:, None] + 31.25
    return {"sorted": srt, "unsorted": unsorted, "skewed": skewed}


def run_vote(torch, flush):
    from motionpriorcmax_tpu_torch.ops.cuda import voxel_vote as vv

    out = {}
    for label, ev in vote_batches(torch).items():
        got = vv.voxel_vote(ev, VOX_NB, VOX_H, VOX_W)
        want = vv.voxel_vote_plain(ev, VOX_NB, VOX_H, VOX_W)
        err = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
        del got, want
        ms, card_ms, host_us = timers(
            torch, lambda: vv.voxel_vote(ev, VOX_NB, VOX_H, VOX_W), flush)
        out[label] = {"ms": ms, "card_ms": card_ms, "host_us": host_us,
                      "max_rel_err": err}
    return out


# Phase 8's batch, cell-sorted or not, made once per run.
host_batch = functools.lru_cache(maxsize=None)(vote_batch)


def run_segsum(torch, flush):
    from motionpriorcmax_tpu_torch.ops.cuda import lut_gather as lg

    batch, loss_cfg = host_batch()
    out = {}
    for label, (g, ends, cells) in segsum_cases(torch, batch,
                                                loss_cfg).items():
        got = lg.lut_segsum_bwd(g, ends, cells)
        same = torch.equal(got.view(torch.int32),
                           lg.lut_segsum_bwd(g, ends, cells).view(torch.int32))
        want = lg.lut_segsum_plain(g, ends, cells)
        err = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
        del got, want
        if not err <= TOL_SEGSUM or not same:
            raise SystemExit(f"kernel_ab: lut_segsum_bwd {label}: error "
                             f"{err:.3e} (bound {TOL_SEGSUM:g}), two calls "
                             f"{'agree' if same else 'differ'} in bits")
        ms, card_ms, host_us = timers(
            torch, lambda: lg.lut_segsum_bwd(g, ends, cells), flush)
        out[label] = {"ms": ms, "card_ms": card_ms, "host_us": host_us,
                      "max_rel_err": err}
    return out


def run_segment_sum(torch, flush):
    from motionpriorcmax_tpu_torch.ops.cuda import segment_sum as ss

    batch, loss_cfg = host_batch(cell_sort=False)
    out = {}
    for label, (rows, cols, g, r, x) in segment_sum_cases(
            torch, batch, loss_cfg).items():
        got = ss.grid_segment_sum(rows, cols, g, r, x)
        want = ss.segment_sum_plain(rows, cols, g, r, x)
        err = float((got - want).abs().max()) / float(want.abs().max())
        del got, want
        if not err <= TOL_SEGMENT_SUM:
            raise SystemExit(f"kernel_ab: grid_segment_sum {label} disagrees "
                             f"with plain: {err:.3e} > {TOL_SEGMENT_SUM:g}")
        ms, card_ms, host_us = timers(
            torch, lambda: ss.grid_segment_sum(rows, cols, g, r, x), flush)
        out[label] = {"ms": ms, "card_ms": card_ms, "host_us": host_us,
                      "max_rel_err": err}
    return out


def run_iwe_vote(torch, flush):
    from motionpriorcmax_tpu_torch.ops.cuda import iwe_vote as iv

    batch, loss_cfg = host_batch()
    h, w = loss_cfg.image_shape
    cases = vote_cases(torch, batch, h, w, loss_cfg.num_bins,
                       loss_cfg.lut_superpixel_size)
    out = {}
    for label, (c, v) in cases.items():
        got = iv.iwe_vote_fwd(c, v, h, w)
        want = iv.iwe_vote_fwd_plain(c, v, h, w)
        err = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
        del got, want
        if not err <= TOL_VOTE_FWD:
            raise SystemExit(f"kernel_ab: iwe_vote_fwd {label} disagrees with "
                             f"plain: {err:.3e} > {TOL_VOTE_FWD:g}")
        share = (vote_band_share(iv, c, v, h, w)
                 if hasattr(iv, "iwe_vote_banded_plain") else None)
        ms, card_ms, host_us = timers(
            torch, lambda: iv.iwe_vote_fwd(c, v, h, w), flush)
        out[label] = {"ms": ms, "card_ms": card_ms, "host_us": host_us,
                      "max_rel_err": err, "band_share": share}
    return out


def digest(t):
    """SHA-1 of t's bytes; + 0.0 makes -0 into +0 (a skipped zero term may
    flip a zero's sign)."""
    import hashlib

    return hashlib.sha1((t + 0.0).contiguous().cpu().numpy().tobytes()
                        ).hexdigest()


def rel_err(got, want):
    return (float((got - want).abs().max())
            / max(1.0, float(want.abs().max())))


def run_iwe_vote_bwd(torch, flush):
    from motionpriorcmax_tpu_torch.ops.cuda import iwe_vote as iv

    batch, loss_cfg = host_batch()
    h, w = loss_cfg.image_shape
    cases = vote_cases(torch, batch, h, w, loss_cfg.num_bins,
                       loss_cfg.lut_superpixel_size)
    b = cases["sorted"][1].shape[0]
    g = torch.Generator(device="cuda").manual_seed(25)
    gimg = torch.randn(b, h, w, device="cuda", generator=g)
    giwes = torch.randn(b, 2, h, w, device="cuda", generator=g)
    runs = [(label, c, v, gimg) for label, (c, v) in cases.items()]
    runs.append(("unsorted_strided", *cases["unsorted"], giwes.select(1, 0)))
    out = {}
    for label, c, v, gr in runs:
        got, _ = iv.iwe_vote_bwd(c, v, gr, h, w, need_dweight=False)
        again, _ = iv.iwe_vote_bwd(c, v, gr, h, w, need_dweight=False)
        same = torch.equal(got.view(torch.int32), again.view(torch.int32))
        want, _ = iv.iwe_vote_bwd_plain(c, v, gr, h, w, need_dweight=False)
        err = rel_err(got, want)
        del again, want
        if not (err <= TOL_VOTE_BWD and same):
            raise SystemExit(f"kernel_ab: iwe_vote_bwd {label}: error "
                             f"{err:.3e} (bound {TOL_VOTE_BWD:g}), two calls "
                             f"{'agree' if same else 'differ'} in bits")
        ms, card_ms, host_us = timers(
            torch, lambda: iv.iwe_vote_bwd(c, v, gr, h, w, need_dweight=False),
            flush)
        out[label] = {"ms": ms, "card_ms": card_ms, "host_us": host_us,
                      "max_rel_err": err, "digest": digest(got)}
        del got
    return out


def run_softmax(torch, flush):
    from motionpriorcmax_tpu_torch.ops.cuda import softmax_interp as si

    out = {}
    for label, (queries, db, vals, slots, temp) in softmax_cases(
            torch, *softmax_loss_cfgs()).items():
        g, _, c = vals.shape
        gs = torch.randn(g, queries.shape[0], c, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(24))
        k_out, k_den = si.softmax_interp_fwd(queries, db, vals, temp, slots)
        k_dv = si.softmax_interp_bwd(queries, db, gs, temp, slots)
        same = torch.equal(k_dv.view(torch.int32), si.softmax_interp_bwd(
            queries, db, gs, temp, slots).view(torch.int32))
        sub = torch.tensor([0, g // 2, g - 1], device="cuda")
        p_out, _ = si.softmax_interp_fwd_plain(queries, db[sub], vals[sub],
                                               temp, slots[sub])
        p_dv = si.softmax_interp_bwd_plain(queries, db[sub], gs[sub], temp,
                                           slots[sub])
        err_f, err_b = rel_err(k_out[sub], p_out), rel_err(k_dv[sub], p_dv)
        del p_out, p_dv
        if not (err_f <= TOL_SOFTMAX and err_b <= TOL_SOFTMAX and same):
            raise SystemExit(f"kernel_ab: softmax {label}: errors {err_f:.3e}"
                             f" / {err_b:.3e} (bound {TOL_SOFTMAX:g}), two "
                             f"backward calls "
                             f"{'agree' if same else 'differ'} in bits")
        res = {"max_rel_err_fwd": err_f, "max_rel_err_bwd": err_b,
               "deterministic": same,
               "digest": {"out": digest(k_out), "den": digest(k_den),
                          "dvals": digest(k_dv)}}
        del k_out, k_den, k_dv
        for name, fn in (
                ("fwd", lambda: si.softmax_interp_fwd(queries, db, vals, temp,
                                                      slots)),
                ("bwd", lambda: si.softmax_interp_bwd(queries, db, gs, temp,
                                                      slots))):
            ms, card_ms, host_us = timers(torch, fn, flush, reps=10)
            res[name] = {"ms": ms, "card_ms": card_ms, "host_us": host_us}
        out[label] = res
        torch.cuda.empty_cache()
    return out


def run_knn(torch, flush):
    """ops/knn.py::knn_blocked as the focus loss calls it, at the flow and
    traj-train shapes on card_cases.knn_case's databases."""
    from motionpriorcmax_tpu_torch.ops import knn

    out = {}
    for label, b, nb, h, w in KNN_PATHS:
        for variant, motion, shuffle in KNN_VARIANTS:
            queries, db = (torch.from_numpy(a).cuda() for a in knn_case(
                48, b, nb, h, w, motion=motion, shuffle=shuffle))
            idx, dist = knn.knn_blocked(queries, db, KNN_K)
            res = {"digest": digest(idx)[:8] + digest(dist)[:8]}
            del idx, dist
            ms, card_ms, host_us = timers(
                torch, lambda: knn.knn_blocked(queries, db, KNN_K), flush,
                reps=5)
            res.update(ms=ms, card_ms=card_ms, host_us=host_us)
            out[f"{label}_{variant}"] = res
            del queries, db
            torch.cuda.empty_cache()
    return out


def staging() -> None:
    """Level 1 staged by cp.async (the port's kernel) and by TMA."""
    import ctypes
    import hashlib
    from pathlib import Path

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    from motionpriorcmax_tpu_torch.ops.cuda import corr_window as cw
    from motionpriorcmax_tpu_torch.ops.cuda.build import NVCC_FLAGS, find_nvcc

    src = Path(__file__).resolve().parent / "tools" / "corr_window_tma.cu"
    lib = src.parent / "_build" / (
        "libcorr_window_tma-"
        + hashlib.sha256(src.read_bytes()).hexdigest()[:16] + ".so")
    if not lib.is_file():
        lib.parent.mkdir(exist_ok=True)
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(lib),
                               str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"kernel_ab: nvcc failed:\n{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).corr_window_tma_level
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.restype = i
    fn.argtypes = [p, p, p, ctypes.c_longlong, i, i, p, i, i, i, i, i, p]

    t, h2, w2 = LEVELS[0]
    corr, cx, cy = level_inputs(torch, t, h2, w2, 0, 200, torch.float32)
    k = (2 * RADIUS + 1) ** 2
    shape = (BATCH, t * k, H // 8, W // 8)
    want = cw.corr_window_lookup_plain(corr, cx, cy, RADIUS,
                                       torch.empty(shape, device="cuda"), 0)
    out_c = torch.full(shape, float("nan"), device="cuda")
    out_t = torch.full(shape, float("nan"), device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def tma():
        err = fn(corr.data_ptr(), cx.data_ptr(), cy.data_ptr(), corr.numel()
                 // (h2 * w2), h2, w2, out_t.data_ptr(), BATCH, Q, t * k, 0,
                 sms, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"kernel_ab: TMA lookup failed: {err}")

    def cp_async():
        cw.corr_window_lookup(corr, cx, cy, RADIUS, out_c, 0)

    tma()
    cp_async()
    torch.cuda.synchronize()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    res = {"level": f"1: N={corr.numel() // (h2 * w2)} maps of {h2}x{w2} f32"}
    for name, f, got in (("cp_async", cp_async, out_c), ("tma", tma, out_t)):
        ms, card_ms, host_us = timers(torch, f, flush)
        res[name] = {"ms": ms, "card_ms": card_ms, "host_us": host_us,
                     "max_abs_err": float((got - want).abs().max())}
    print(json.dumps(res), flush=True)


def run_flax_bn(torch, flush):
    """FlaxBatchNorm2d's train-mode forward and backward at FLAX_BN_SHAPES,
    in the checkout's form, and their sums over the UNet's 18 norms."""
    import inspect

    from torch import nn

    from motionpriorcmax_tpu_torch.models.norm import FlaxBatchNorm2d

    fuses = "relu" in inspect.signature(FlaxBatchNorm2d).parameters
    out, step = {}, {"ms": 0.0, "card_ms": 0.0, "host_us": 0.0}
    for label, b, c, hw, dname, relu, count in FLAX_BN_SHAPES:
        x, dy, _, _ = flax_bn_inputs(torch, b, c, hw, getattr(torch, dname),
                                     c)
        if relu and not fuses:
            layer = nn.Sequential(FlaxBatchNorm2d(c), nn.ReLU())
        else:
            layer = FlaxBatchNorm2d(c, relu=True) if relu else \
                FlaxBatchNorm2d(c)
        layer = layer.cuda().train()
        xr = x.clone().requires_grad_(True)

        def fwd_bwd():
            xr.grad = None
            layer.zero_grad(set_to_none=True)
            layer(xr).backward(dy)

        ms, card_ms, host_us = timers(torch, fwd_bwd, flush)
        out[label] = {"ms": ms, "card_ms": card_ms, "host_us": host_us}
        if label.startswith("unet"):
            for k in step:
                step[k] += count * out[label][k]
        del x, dy, xr, layer
        torch.cuda.empty_cache()
    out["unet_step"] = step
    return out


SECTIONS = {"lookup": run_lookup, "voxel_vote": run_vote,
            "iwe_vote": run_iwe_vote, "iwe_vote_bwd": run_iwe_vote_bwd,
            "segsum": run_segsum,
            "segment_sum": run_segment_sum, "softmax": run_softmax,
            "knn": run_knn, "flax_bn": run_flax_bn}
# The cases of each section, in the order of the table.
CASES = {"voxel_vote": ("sorted", "unsorted", "skewed"),
         "iwe_vote": ("sorted", "unsorted", "skewed", "wide"),
         "iwe_vote_bwd": ("sorted", "unsorted", "skewed", "wide",
                          "unsorted_strided"),
         "segsum": ("sorted", "skewed", "traj"),
         "segment_sum": ("path", "skewed", "traj"),
         "knn": tuple(f"{p[0]}_{v[0]}" for p in KNN_PATHS
                      for v in KNN_VARIANTS),
         "flax_bn": tuple(s[0] for s in FLAX_BN_SHAPES) + ("unet_step",)}


def worker(label: str, tree: str, sections: str) -> None:
    tree = os.path.abspath(tree)
    sys.path[0] = tree                      # this checkout's package only
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    import motionpriorcmax_tpu_torch as pkg
    from motionpriorcmax_tpu_torch.ops.cuda.build import build_library

    if not os.path.abspath(pkg.__file__).startswith(tree + os.sep):
        raise SystemExit(f"kernel_ab: imported {pkg.__file__}, not {tree}'s")
    for name in ("corr_window", "voxel_vote", "iwe_vote", "lut_gather",
                 "segment_sum", "softmax_interp"):
        build_library(name)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    res = {"run": label, "tree": tree}
    for name in sections.split(","):
        res[name] = SECTIONS[name](torch, flush)
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="label=checkout path")
    ap.add_argument("--order", help="labels in run order (default: as given)")
    ap.add_argument("--staging", action="store_true",
                    help="level 1 staged by cp.async and by TMA, here")
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help="comma-separated sections to run (default: all)")
    ap.add_argument("--worker", nargs=2, metavar=("LABEL", "TREE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    unknown = set(args.sections.split(",")) - set(SECTIONS)
    if unknown:
        ap.error(f"unknown sections {sorted(unknown)}; known: "
                 f"{list(SECTIONS)}")
    if args.worker:
        worker(*args.worker, args.sections)
        return 0
    if args.staging:
        print(nvidia_smi_line(), flush=True)
        staging()
        return 0
    trees = dict(t.split("=", 1) for t in args.trees)
    if not trees:
        ap.error("give at least one label=path")
    order = args.order.split(",") if args.order else list(trees)
    print(nvidia_smi_line(), flush=True)
    results = []
    for label in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", label,
             trees[label], "--sections", args.sections],
            capture_output=True, text=True, timeout=900)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"kernel_ab: run {label} failed (rc {proc.returncode})")
            return 1
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    def cell(c):
        dg = f" {c['digest'][:8]}" if "digest" in c else ""
        return (f"{c['ms'] * 1e3:.1f}/{c['card_ms'] * 1e3:.1f}/"
                f"{c['host_us']:.0f}{dg}")

    print("each: ms / card_ms in us / host_us (/ digest)")
    for r in results:
        parts = []
        if "lookup" in r:
            lk = r["lookup"]
            parts.append(f"lookup {cell(lk)} ({lk['launches_per_iteration']} "
                         f"launches), level 1 {lk['level1_ms'] * 1e3:.1f}/"
                         f"{lk['level1_card_ms'] * 1e3:.1f}")
        parts += [f"{name} " + "  ".join(f"{k} {cell(r[name][k])}"
                                         for k in keys)
                  for name, keys in CASES.items() if name in r]
        parts += [f"softmax {k} fwd {cell(v['fwd'])} bwd {cell(v['bwd'])} "
                  f"digest {'/'.join(d[:8] for d in v['digest'].values())}"
                  for k, v in r.get("softmax", {}).items()]
        print(f"{r['run']:<10} " + " | ".join(parts))
    return 0


if __name__ == "__main__":
    sys.exit(main())

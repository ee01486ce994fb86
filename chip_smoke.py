#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, one or more lines each; any failure exits non-zero.  Numbers 6,
12, 17, 23 and 28 are retired: where a path's time goes is measured by the
program's spans under utils/profiling.py's `trace` and, for a benchmark
cell, by `python -m perfbench.run --workload <cell> --trace 1`.
  1. environment: card name and count, nvidia-smi name and power limit, and
     the process's TF32 flags, left at torch's defaults as the CLI leaves
     them (the models' forwards turn both off for compute_dtype float32)
  2. build: every kernel source in motionpriorcmax_tpu_torch/csrc, one nvcc
     per source, all started together, for sm_90a, with the -Xptxas -v
     register report, and beside them the native host library
     (motionpriorcmax_tpu_torch/native/event_ops.cc, g++)
  traj-val (RAFT-Spline Tab2L5 serving, EVIMO2 geometry):
  3. kernel vs plain: one launch of the corr-window kernel over the four
     pyramid-level shapes of the EVIMO2 batch-8 path and a level of width
     10, against the plain per-level versions, f32 and bf16 volumes, with
     coordinates outside the maps; the staging path of each level
  4. timing (CUDA events, L2 flushed between launches) per refinement
     iteration: the one launch over levels 1-4, its memory bound, the
     plain version, and F.grid_sample per level (align_corners=True, zero
     padding; the reference's own sampler, never called by the port); each
     level alone beside it
  5. serving: raft_validation_step with seeded random weights on 1 warm-up
     + 3 synthetic B=8 384x512 requests: latency, samples/s, peak memory,
     kernel launches per request (12: one per refinement iteration),
     finite metrics, TF32 off inside every forward
  7. card vs CPU: the same weights and inputs through the port on the CPU
     (plain lookup) and on the card (kernel) at the small test geometry
  flow-train (self-supervised DSEC flow training, config/flow_training/
  dsec.yaml: 480x640, 15 bins, batch 14, bf16 UNet, capacity 2^20):
  8. host batch: 14 synthetic samples of ~1M events from a numpy seed,
     voxelized on the host and collated by the port (polarity packing,
     LUT-cell sort, cell_ends); the collate time of one batch
  9. kernels vs plain at the path's shapes: the IWE vote forward and
     backward (B=14, M=2^19 per polarity half, 480x640) on cell-sorted
     events (kernel row 3) and on the same events unsorted (row 4), the
     forward also on a skewed batch (a hot pixel, sorted again) and with a
     6x wider flow, with the share of taps that the forward's plain twin
     votes through its shared-memory band; the LUT gather (LUT [14, 1800,
     160, 2], 2^20 events) and its sorted segment sum (S=2) on the
     path's batch, on a skewed one sorted again and at the traj-train
     shape (B=6, 2^18 padding rows per half), two calls giving the same
     bits; 5% of the warped coordinates far outside the image
 10. timing of each kernel (CUDA events, L2 flushed): kernel, bytes bound
     at 3.35 TB/s, plain version, and one PyTorch call as the yardstick
     (index_put_ accumulate for the vote, advanced indexing for the
     gather, index_add_ for the segment sum; none for the vote backward);
     the card time alone of the vote forward on its four inputs and of
     the segment sum on its three
 11. training: train_flow (the CLI's loop) at full width with seeded
     weights on 1 warm-up + 2 timed steps and one val pass with GT flow,
     checkpoint to a temporary directory: step ms, events/s, peak memory,
     kernel launches per step (2 + 2 vote, 1 + 1 gather, 1 exact KNN) and
     in the val pass, finite loss that changes, finite val EPE
 13. card vs CPU: one f32 train_step at the test geometry, kernels on the
     card against plain versions on the CPU: loss, gradients, BN statistics
  flow-train with loss.knn_method: softmax and voxel grids built in the
  step (--device-voxelize), on phase 8's batches without their 'voxel':
 14. kernels vs plain at the path's shapes: the softmax interpolation
     forward and backward (G=210 groups, Q=N=19,200, per-bin band rows,
     trajectories moved up to 60 px, 1% far outside the image; the plain
     versions on 4 of the groups, kernel rows 7; the backward's bits the
     same in two calls; the same at the traj-train softmax step's shapes;
     the pairs scanned, needed (a nonzero weight) and computed, counted by
     the kernels and equal to their PyTorch twin's count; one query
     against points at squared distances around the cut, f32 and bf16, no
     nonzero weight within 1 of it, none dropped, each equal to plain) and
     the voxel vote of the
     14 x 2^20 cell-sorted events, of the same events unsorted and skewed
     (half the live events of a sample in one 16 x 64 region, 1% on one
     pixel), and of events on tile edges and corners and at the clamp
     limits (row 8)
 15. timing (CUDA events, L2 flushed): kernel, bound (row 7: the larger
     of exp2 at the SFU rate and f32 instructions over the needed pairs,
     from nvidia-smi's maximum SM clock, and bytes; bytes for row 8), plain
     version, and one PyTorch call (scaled_dot_product_attention, dense
     and without band, for the forward, with its difference to the kernel;
     none for the backward; index_add_ of the eight taps for the vote); the
     skewed vote's time; row 7 also at the traj-train softmax step's
     shapes (G=246, Q=N=12,288, C=4, per-group dynamic band)
 16. training: train_flow as in phase 11: launches per step 1 + 1 softmax,
     1 voxel vote and the 6 of phase 11; in the val pass 1 softmax forward
     and 1 voxel vote; 1 warm-up + 3 timed steps, their four losses
     against the recorded ones
 18. card vs CPU: one f32 train_step of this configuration at the test
     geometry
  traj-train (RAFT-Spline training, the Tab2L5 experiment config as it
  stands: B=6, 384x512, 12 iterations, f32, exact-KNN focus loss):
 19. kernel vs plain: the corr-window backward kernel (d corr, d cx, d cy)
     against its plain version at the four level shapes of the B=6 path,
     f32 and bf16 volumes, with coordinates outside the maps; then the
     lookup with both kernels (forward and backward) against torch
     autograd of the plain lookup
 20. timing (CUDA events, L2 flushed) per refinement iteration (4
     launches): the backward kernel, its bytes bound, the plain version,
     and F.grid_sample's backward (d input and d grid; the reference's
     sampler, never called by the port); the forward kernel's one launch
     at B=6
 21. training: train_traj (the traj-train CLI's loop) at full width with
     seeded weights on synthetic batches of 2^19 events per sample: 1
     warm-up + 2 timed steps + 1 under torch.profiler (idle share), then a
     validation pass and a checkpoint: step ms, events/s, peak memory,
     launches per step (12 + 48 corr-window, 2 + 2 vote, 1 + 1 gather), a
     finite loss that moves, context BatchNorm statistics that move, TF32
     off in the forward and the backward, finite validation metrics
 22. the same loop with loss.knn_method softmax (+ 1 + 1 softmax
     launches; the first three steps' losses against the recorded ones),
     and with the supervised step (gamma 0.8, 5 GT steps)
 24. card vs CPU: one f32 raft_train_step and one supervised step at the
     test geometry: loss, gradients, BatchNorm statistics
  flow-train on unsorted events (dsec.yaml with loss.knn_method: softmax
  and the voxel grid voted in the step, on phase 8's samples collated
  without the LUT-cell sort, the DataLoader's default):
 25. kernel vs plain: the any-order segment sum (kernel row 5, the LUT
     gather's backward) at the step's shapes (B=14, M=2^20, LUT [1800,
     160, 2], ~4.6% padding with zero cotangent), on a skewed batch in
     time order, at the traj-train shapes ([6, 3936, 128, 2], 2^19 events
     per sample) and with every cotangent on 8 cells per sample
 26. its timing (CUDA events, L2 flushed; also the card's time alone):
     kernel, bytes bound, plain version, torch.gather's backward
     (scatter_add_); the skewed batch; with the padding rows' cotangent
     nonzero, and with no padding
 27. training: train_flow on the unsorted batches: launches per step 1
     segment sum, 2 + 2 vote (row 4), 1 voxel vote, 1 + 1 softmax and no
     LUT gather; TF32 off in the UNet's forward and backward; the four
     step losses against phase 16's recorded ones; the cell-sorted step
     of phase 16 beside it
 29. card vs CPU: one f32 unsorted train_step at the test geometry
 30. the JAX package's learning checks on the card, on unsorted events:
     loss-only recovery of a translation (exact and softmax, 45 Adam
     steps) and the UNet self-supervised step (120 steps), with their
     thresholds
  host data:
 31. DataLoader batches/s over in-memory synthetic DSEC windows (native
     pack, host voxel grid and LUT-cell sort on the pool, pinned batches)
     for {cell-sorted, unsorted} x {host, device voxel}, each against the
     step that consumes it; one batch's collate with the NumPy twins in
     one thread and with the native ops on the pool
  dsec-infer (DSEC benchmark inference, config/dsec_inference.yaml: B=1,
  480x640, 15 bins, f32 UNet 64-1024, seeded weights):
 32. the voxel vote (row 8) against its plain version at the inference
     shapes: B=1 with N = 0, 1, 4097 (not a multiple of the 4096-event
     chunk), 2^20 and 3M events, fractional rectified coordinates, 4% on
     the last row or column; at 2^20 and 3M its time (L2 flushed, and the
     card's alone), its bytes bound (24 N + 4 x 15 x 480 x 640 at 3.35
     TB/s), the plain version and index_add_ of the eight taps
 33. end to end at full width: the CLI's infer_sequence over an in-memory
     sequence of 9 windows of 0.5-3M raw events (the arrays of an
     events.h5, a synthetic rectify map, a timestamp CSV), read through
     DsecSequence.__getitem__ (the native pack), 1 warm-up + 8 timed
     windows: ms per window, windows/s, peak memory, 1 voxel-vote launch
     per window, TF32 off inside the forward, every PNG read back (finite,
     within the 60 px cap); then the parts of each window with the card
     synchronized at each (CUDA events; the host clock for the pack and
     the PNG), timed by wrapping the functions the CLI looks up by name,
     and the 416 windows of the seven test CSVs, derived (printed only)
 34. card vs CPU: the same seeded weights at narrow widths and two
     windows through infer_window on the CPU (plain) and the card (kernel)
  flow-train's remaining configuration values (dsec.yaml's shapes, 1
  warm-up + 1 timed step each):
 35. train_flow with loss.knn_method grid on phase 8's cell-sorted
     host-voxel batch (the spatial-hash KNN, plain PyTorch; rows 3 and 6),
     then card vs CPU at the test geometry
 36. train_flow with knn_method softmax and dist_norm l1 on the device-voxel
     batch (the blockwise L1 interpolation, plain PyTorch; rows 3, 6 and
     8), then card vs CPU
 37. one batch through the DataLoader with capacity buckets (2^19, 2^20)
     from 14 windows of 300,000 events: 2^18 per polarity half, 2^19 in
     all; train_flow's softmax / device-voxel step on it
  flow-train's epoch image panels (dsec.yaml's shapes, phase 8's windows
  with GT flow):
 38. one train_flow epoch (1 train step, the panel of 5 of the 14 windows,
     the val pass), each panel sample collated alone as the CLI's val
     loader collates it (DataLoader.collate: capacity 2^20, polarity
     packing, LUT-cell sort): the 25 PNGs named as the JAX package names
     them and read back as 480x640 RGB, ms per render, collate and
     colorize + PNG, launches per render (5 vote forwards, 1 LUT gather,
     2 exact KNNs); then the same with knn_method softmax and the voxel
     grid voted in the render (+2 softmax forwards, +1 voxel vote, no
     exact KNN)
 39. card vs CPU: one sample's render at the test geometry (f32 UNet),
     exact KNN with the host voxel and softmax with the device voxel
  RAFT-Spline with model.compute_dtype and model.corr_dtype bfloat16:
 40. traj-val: phase 5 with the bf16 model (latency, samples/s, peak
     memory, 12 launches per request, TF32 off beside the bf16 convs);
     then the fused lookup (row 1) on a request's bf16 pyramid against its
     plain version, its card time beside the same windows on the volumes
     widened to f32, and its bytes bound
 41. traj-train: phase 21's loop with the bf16 model on its batch (step
     ms, peak memory, 12 + 48 corr-window launches per step, a loss that
     moves); then the backward kernel (row 2) on the step's bf16 pyramid,
     level by level, against its plain version, and its card time beside
     the same on f32 volumes
 42. card vs CPU: the bf16 model at the test geometry, its forward and one
     self-supervised raft_train_step (loss, the gradients' cosine), with
     the tolerances of tests/test_torch_raft_bf16.py
  multi-process training (motionpriorcmax_tpu_torch/parallel/; every
  sharded step computes the single-device step of the global batch):
 43. the CLI's process group on the card: initialize_distributed over
     NCCL, a world of one, make_mesh, train_flow's sharded path on phase
     11's configuration and batch (exact KNN, host voxel): launches per
     step, the bytes all-reduced per step, step ms beside phase 11's
 44. two ranks on the one card over gloo (CUDA tensors; the collectives
     pass through the host), each a process of this script (--rank R PORT
     DIR), at dsec.yaml's full width with loss.knn_method softmax and the
     voxel grid voted in the step, SGD from the seed-0 weights: mesh (1, 2)
     on the cell-sorted batch (rows 8, 3, 6 on clipped cell ends, 7) and
     (2, 1) on the unsorted batch (rows 8, 4, 5, 7); per rank its launches,
     step ms, peak memory and bytes all-reduced per step, and the first
     step's loss and weights against the single-process step of the global
     batch on the card, with tests/test_torch_parallel.py's tolerances
 45. the same for traj-train (Tab2L5, B=6, exact KNN) at (2, 1) and
     (1, 2): rows 1, 2, 3 and 6
 46. MetricBank.reduce_across_processes over the two ranks (1 and 2 ->
     1.5), and train_flow on the (2, 1) mesh writing its scalars and
     checkpoint from rank 0 alone; a rank that fails or outlasts its
     timeout fails the script
 47. ops/scatter.py's scatter_add_1d on the card: the same bits in two
     calls, against a float64 sum
  the exact KNN (ops/knn.py::knn_blocked, knn_method exact and approx):
 48. the fused distance + top-K kernel (csrc/knn_topk.cu) at the
     flow-training shape (G=210, Q=N=19,200, K=32) and the traj-train one
     (G=246, Q=N=12,288) on make_trajectories-like points (knn_case) in
     the loss's order, shuffled, and with a flow ten times as large: one
     launch per knn_blocked call, the same bits in two calls, check_knn
     (the K smallest values in order, distances bit for bit the plain
     refinement's, index sets torch.topk's except at ties at the K-th
     value, taken to the lower index); its time (CUDA events, L2 flushed)
     on each database, beside its bound (5 f32 operations per pair at the
     maximum SM clock) and the plain version's, which is knn_blocked
     before the kernel (distance blocks, torch.topk)
 49. flax's BatchNorm (+ ReLU) kernels (csrc/flax_batch_norm.cu) at the
     UNet's norm shapes at B=14 (bf16) and the RAFT context encoder's at
     B=6 (f32): the elementwise passes against their plain versions bit
     for bit, the sums to 1e-5 of their scale, the same bits in two calls;
     the time of one norm's train-mode forward and backward (CUDA events,
     L2 flushed): the four launches, the whole norm, its byte bound, the
     plain versions, and F.batch_norm + F.relu (cuDNN, the library
     yardstick, never called by the port); the sums over the UNet's 18
     norms of one step

The line before the last is a JSON object with the kernels' numbers; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

from card_cases import (
    BATCH, DSEC_CONFIG, DSEC_INFERENCE_CONFIG, FLAX_BN_SHAPES, FLOW_CAPACITY,
    FLOW_EVENTS, H, INFER_PARTS, K, KNN_K, KNN_OPS_PER_PAIR, KNN_PATHS,
    KNN_VARIANTS, LEVELS, Q, RADIUS, TAB2L5_CONFIG, TOL_SEGMENT_SUM,
    TOL_SEGMENT_SUM_FEW, TOL_SEGSUM, TOL_SOFTMAX, TOL_VOTE_BWD, TOL_VOTE_FWD,
    TOL_VOXEL, TRAIN_BATCH, TRAIN_CAPACITY, TRAIN_EVENTS, TRAIN_STEPS, W,
    check_knn, flax_bn_check, flax_bn_inputs, flow_configs, flow_samples,
    infer_part_marks, knn_case, level_inputs, nvidia_smi_line,
    segment_sum_cases, segsum_cases, skewed_events, softmax_cases,
    softmax_loss_cfgs, timers, vote_band_share, vote_cases)

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12            # f32 outside the tensor cores
TOL_KERNEL = 1e-5
TOL_CARD_VS_CPU = 1e-4
# One fused lookup launch (all levels) per refinement iteration, 12 per
# request.
LOOKUPS_PER_REQUEST = 12


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def phase_env(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi_line = nvidia_smi_line()
    print(f"[env] device={name!r} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda} process tf32 flags (torch defaults, as "
          f"the CLI leaves them): matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    print(smi_line)
    return name, count, smi_line


def phase_build():
    """Build every csrc/*.cu at once (one nvcc each, in parallel)."""
    from concurrent.futures import ThreadPoolExecutor

    from motionpriorcmax_tpu_torch.ops.cuda.build import CSRC_DIR, build_library

    from motionpriorcmax_tpu_torch import native

    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + 1) as pool:
        host = pool.submit(native.build)
        built = list(pool.map(build_library, names))
        host_lib = host.result()
    print(f"[build] {len(names)} sources in {time.perf_counter() - t0:.1f} s "
          "(nvcc -gencode arch=compute_90a,code=sm_90a, in parallel) and the "
          f"native host library {host_lib.name} "
          f"({' '.join(native.CXX_FLAGS)})")
    if not native.available():
        fail(f"the native host library did not load: {native.build_error()}")
    for path, log in built:
        print(f"[build] {path.name}")
        for line in log.splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                print(f"[build]   {line.strip()}")


def needed_bytes(torch, corr, cx, cy):
    """Bytes the lookup must move for these inputs: the in-range window
    values (each once), the two coordinates and the K outputs per query."""
    h2, w2 = corr.shape[-2:]
    x0 = torch.floor(cx).clamp(-1e7, 1e7) - RADIUS
    y0 = torch.floor(cy).clamp(-1e7, 1e7) - RADIUS
    win = 2 * RADIUS + 2
    nx = (torch.minimum(x0 + win - 1, torch.tensor(w2 - 1.0, device=cx.device))
          - torch.clamp(x0, min=0) + 1).clamp(min=0)
    ny = (torch.minimum(y0 + win - 1, torch.tensor(h2 - 1.0, device=cy.device))
          - torch.clamp(y0, min=0) + 1).clamp(min=0)
    window_elems = float((nx * ny).sum().item())
    n = cx.numel()
    return window_elems * corr.element_size() + n * 8 + n * K * 4


# A level of width 10 beside the path's four in phase 3's fused launch:
# rows at any 4-byte offset, and bf16 rows at odd element offsets.
UNALIGNED_LEVEL = (1, 12, 10)


def level_set(torch, levels, seed, dtype, batch=BATCH):
    """(corr, cx, cy, chan_off) per level from level_inputs, level-major
    channel slabs, and the slab count."""
    out, off = [], 0
    for lvl, (t, h2, w2) in enumerate(levels):
        corr, cx, cy = level_inputs(torch, t, h2, w2, min(lvl, 3), seed + lvl,
                                    dtype, batch)
        out.append((corr, cx, cy, off))
        off += t * K
    return out, off


def phase_kernel(torch):
    """Phases 3-4: the lookup of all levels in one launch against the plain
    per-level versions, then timed per refinement iteration."""
    from torch.nn import functional as F

    from motionpriorcmax_tpu_torch.ops.cuda import corr_window as cw

    max_err = 0.0
    shapes = LEVELS + [UNALIGNED_LEVEL]
    for dtype in (torch.float32, torch.bfloat16):
        levels, c_total = level_set(torch, shapes, 100, dtype)
        out_k = torch.full((BATCH, c_total, H // 8, W // 8), float("nan"),
                           device="cuda")
        out_p = torch.full_like(out_k, float("nan"))
        before = cw.corr_window_lookup.launches
        cw.corr_window_lookup_levels(levels, RADIUS, out_k)
        cw.corr_window_lookup_levels_plain(levels, RADIUS, out_p)
        torch.cuda.synchronize()
        if cw.corr_window_lookup.launches != before + 1:
            fail("the fused lookup did not make exactly one launch")
        if not torch.isfinite(out_k).all():
            fail(f"{dtype}: the fused lookup left non-finite outputs")
        for (corr, _, _, off), (t, h2, w2) in zip(levels, shapes):
            err = float((out_k[:, off:off + t * K]
                         - out_p[:, off:off + t * K]).abs().max().item())
            max_err = max(max_err, err)
            print(f"[kernel-vs-plain] fused launch of {len(shapes)} levels, "
                  f"level map {h2}x{w2} N={corr.shape[0] * BATCH * Q} "
                  f"{str(dtype)[6:]}: max_abs_diff={err:.3e} "
                  f"(bound {TOL_KERNEL:g}); staging cp.async (4-byte LDGSTS,"
                  f" zero-fill{', aligned pairs' if dtype == torch.bfloat16 else ''})")
            if err > TOL_KERNEL:
                fail(f"the fused lookup disagrees with plain at map "
                     f"{h2}x{w2} {dtype}")
        del levels, out_k, out_p
    torch.cuda.empty_cache()

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    levels, c_total = level_set(torch, LEVELS, 200, torch.float32)
    out = torch.empty(BATCH, c_total, H // 8, W // 8, device="cuda")
    totals = dict(plain_ms=0.0, bound_ms=0.0, library_ms=0.0, level_ms=0.0,
                  level_card_ms=0.0)
    for lvl, ((corr, cx, cy, off), (t, h2, w2)) in enumerate(
            zip(levels, LEVELS)):
        n = corr.shape[0] * BATCH * Q
        # grid_sample's grid: the (2r+1)^2 sample points of each query in
        # [-1, 1] (align_corners=True), row-major over (dy, dx).
        d = torch.arange(-RADIUS, RADIUS + 1, device="cuda", dtype=torch.float32)
        gx = cx.reshape(n, 1, 1) + d[None, None, :]
        gy = cy.reshape(n, 1, 1) + d[None, :, None]
        grid = torch.stack([2 * gx.expand(n, 2 * RADIUS + 1, 2 * RADIUS + 1)
                            / (w2 - 1) - 1,
                            2 * gy.expand(n, 2 * RADIUS + 1, 2 * RADIUS + 1)
                            / (h2 - 1) - 1], dim=-1).contiguous()
        img = corr.reshape(n, 1, h2, w2)
        one = [(corr, cx, cy, off)]
        k_ms, kc_ms, _ = timers(torch, lambda: cw.corr_window_lookup_levels(
            one, RADIUS, out), flush)
        p_ms = timers(torch, lambda: cw.corr_window_lookup_levels_plain(
            one, RADIUS, out), flush)[0]
        l_ms = timers(torch, lambda: F.grid_sample(
            img, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True), flush)[0]
        nbytes = needed_bytes(torch, corr, cx, cy)
        flops = n * K * 7
        bound = max(nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS) * 1e3
        print(f"[timing] level {lvl + 1} N={n} map {h2}x{w2} f32: "
              f"kernel alone={k_ms * 1e3:.1f} us (card {kc_ms * 1e3:.1f} us) "
              f"bound={bound * 1e3:.1f} us "
              f"({nbytes / 1e6:.1f} MB needed, bytes-bound) "
              f"plain={p_ms * 1e3:.1f} us grid_sample={l_ms * 1e3:.1f} us")
        for key, v in (("plain_ms", p_ms), ("bound_ms", bound),
                       ("library_ms", l_ms), ("level_ms", k_ms),
                       ("level_card_ms", kc_ms)):
            totals[key] += v
        del grid, img, gx, gy
    totals["ms"], totals["card_ms"], _ = timers(
        torch, lambda: cw.corr_window_lookup_levels(levels, RADIUS, out),
        flush)
    rest_ms = timers(torch, lambda: cw.corr_window_lookup_levels(
        levels[1:], RADIUS, out), flush)[0]
    del flush, levels, out
    torch.cuda.empty_cache()
    print(f"[timing] one refinement iteration (1 launch, levels 1-4): "
          f"kernel={totals['ms'] * 1e3:.1f} us (card "
          f"{totals['card_ms'] * 1e3:.1f} us; levels 2-4 alone in one "
          f"launch {rest_ms * 1e3:.1f} us; the 4 levels launched one by one "
          f"{totals['level_ms'] * 1e3:.1f} us, card "
          f"{totals['level_card_ms'] * 1e3:.1f} us) "
          f"bound={totals['bound_ms'] * 1e3:.1f} us "
          f"plain={totals['plain_ms'] * 1e3:.1f} us "
          f"grid_sample={totals['library_ms'] * 1e3:.1f} us")
    return max_err, totals


def synthetic_request(torch, cfg, seed):
    """An EVIMO2-shaped B=8 request from a numpy seed: a sparse normalized
    voxel grid, GT flow at the 6 timestamps and a validity mask."""
    rng = np.random.default_rng(seed)
    shape = (BATCH, cfg.nbins_total, H, W)
    ev = rng.standard_normal(shape, dtype=np.float32)
    ev *= rng.random(shape, dtype=np.float32) < 0.3
    flow = 5 * rng.standard_normal((BATCH, 6, 2, H, W), dtype=np.float32)
    valid = rng.random((BATCH, 6, H, W), dtype=np.float32) > 0.2
    return {"ev_repr": torch.from_numpy(ev), "flow": torch.from_numpy(flow),
            "flow_valid": torch.from_numpy(valid)}


def tf32_flags(torch):
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def phase_serving(torch, model, requests, ts, tag="serving"):
    """Time raft_validation_step from host batch to metrics; returns the
    kernel's launch count over the run."""
    from motionpriorcmax_tpu_torch.metrics import MetricBank
    from motionpriorcmax_tpu_torch.ops.cuda import corr_window as cw
    from motionpriorcmax_tpu_torch.training.raft_spline import \
        raft_validation_step

    # The TF32 flags as the convolutions see them, inside every forward.
    seen = set()
    hooks = [getattr(model, name).register_forward_pre_hook(
        lambda mod, inp: seen.add(tf32_flags(torch)))
        for name in ("fnet_ev", "cnet", "update_block")]
    bank = MetricBank()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cw.corr_window_lookup.launches = 0
    lat, per_request = [], []
    for i, host_batch in enumerate(requests):
        before = cw.corr_window_lookup.launches
        t0 = time.perf_counter()
        batch = {k: v.to("cuda", non_blocking=False)
                 for k, v in host_batch.items()}
        logs = raft_validation_step(model, batch, ts)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        per_request.append(cw.corr_window_lookup.launches - before)
        bad = [k for k, v in logs.items() if not torch.isfinite(v).all()]
        if bad:
            fail(f"request {i}: non-finite metrics {bad[:5]}")
        if i > 0:                      # request 0 is the warm-up
            lat.append(dt)
            bank.update_device(logs)
        print(f"[{tag}] request {i}{' (warm-up)' if i == 0 else ''}: "
              f"{dt * 1e3:.1f} ms, corr_window launches {per_request[-1]}")
    launches = cw.corr_window_lookup.launches
    peak = torch.cuda.max_memory_allocated()
    for h in hooks:
        h.remove()
    results = bank.compute()
    if any(n != LOOKUPS_PER_REQUEST for n in per_request):
        fail(f"expected {LOOKUPS_PER_REQUEST} corr_window launches per "
             f"request, got {per_request}")
    if not all(np.isfinite(v) for v in results.values()):
        fail("non-finite metrics in the bank")
    if seen != {(False, False)}:
        fail(f"the forward ran with TF32 flags (matmul, cudnn) {seen}")
    mean = float(np.mean(lat))
    mc = model.cfg
    print(f"[{tag}] Tab2L5 B={BATCH} {H}x{W} compute {mc.compute_dtype}, "
          f"corr {mc.corr_dtype}, 12 iterations: latency "
          f"mean {mean * 1e3:.1f} ms over {len(lat)} requests "
          f"({', '.join(f'{x * 1e3:.1f}' for x in lat)}), "
          f"{BATCH / mean:.2f} samples/s, peak memory {peak / 2**30:.2f} GiB")
    print(f"[{tag}] {len(results)} metrics finite; val/masked_TEPE="
          f"{results['val/masked_TEPE']:.4f} val/epe={results['val/epe']:.4f}; "
          f"TF32 (matmul, cudnn) inside the forward: {sorted(seen)}")
    return launches


def phase_card_vs_cpu(torch):
    from motionpriorcmax_tpu_torch.models.raft_spline import RAFTSplineConfig
    from motionpriorcmax_tpu_torch.ops.cuda import corr_window as cw
    from motionpriorcmax_tpu_torch.training.raft_spline import create_raft_model

    cfg = RAFTSplineConfig(nbins_context=5, nbins_correlation=3,
                           bezier_degree=2, ev_target_indices=(2, 4),
                           ev_levels=(1, 2), iters=2)
    cpu_model = create_raft_model(cfg, "cpu", torch.Generator().manual_seed(1))
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    voxel = np.random.default_rng(2).standard_normal(
        (2, cfg.nbins_total, 32, 32), dtype=np.float32)
    before = cw.corr_window_lookup.launches
    with torch.inference_mode():
        _, up_cpu = cpu_model(torch.from_numpy(voxel), test_mode=True)
        _, up_gpu = gpu_model(torch.from_numpy(voxel).cuda(), test_mode=True)
    torch.cuda.synchronize()
    rel = float((up_gpu.cpu() - up_cpu).abs().max() / up_cpu.abs().max())
    print(f"[card-vs-cpu] params_up {tuple(up_cpu.shape)}: max rel diff "
          f"{rel:.3e} (bound {TOL_CARD_VS_CPU:g}, TF32 off in the forward), "
          f"card launches {cw.corr_window_lookup.launches - before}")
    if not rel <= TOL_CARD_VS_CPU:
        fail("card and CPU forwards disagree")


# ---------------------------------------------------------------------------
# flow-train: self-supervised DSEC flow training
# ---------------------------------------------------------------------------

FLOW_STEPS = 3                     # 1 warm-up + 2 timed
# (the phases that hold SOFTMAX_STEP_LOSSES take one step per loss)
TOL_TRAIN_LOSS = 1e-4              # card vs CPU, relative
# The softmax / device-voxel steps' losses on phase 8's batches, as the
# port printed them before the voxel vote's tiles (cell-sorted; the
# unsorted batch gave the same to 1e-6): a voxel grid summed in another
# order moves them by far less than this bound.
SOFTMAX_STEP_LOSSES = (0.502358, 0.494246, 0.476255, 0.495910)
# The traj-train softmax steps' first three losses (phase 22), as the port
# printed them in four runs of this script on an H100 (NVIDIA H100 80GB
# HBM3, 700 W), the same to six digits in each.  Later steps are not held:
# by step 3 the runs spread by 1.3e-4 and by step 4 by 1.4e-4 (relative),
# as the exact-KNN traj-train steps spread too, from sums in a
# run-dependent order elsewhere in the step (the IWE vote's float atomics,
# for one) that the optimizer carries on.
TRAJ_SOFTMAX_STEP_LOSSES = (0.559594, 0.549575, 0.529107)
TOL_STEP_LOSS = 1e-4               # relative
TOL_TRAIN_GRAD = 1e-4              # card vs CPU, of each tensor's largest
TOL_TRAIN_BN = 1e-4                # card vs CPU, of each buffer's largest


def phase_flow_batch(cfg, loss_cfg, batch_size):
    from motionpriorcmax_tpu_torch.data.collate import collate_fixed_capacity

    h, w = cfg.image_shape
    t0 = time.perf_counter()
    samples = flow_samples(7, batch_size, FLOW_EVENTS, h, w, cfg.num_bins,
                           gt=True)
    t_make = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = collate_fixed_capacity(
        samples, FLOW_CAPACITY, polarity_aware=True,
        lut_cell_sort_params=(loss_cfg.image_shape, loss_cfg.num_bins,
                              loss_cfg.lut_superpixel_size))
    t_collate = time.perf_counter() - t0
    valid = int(batch["events"][..., 5].sum())
    print(f"[flow-batch] {batch_size} samples x {FLOW_EVENTS} events, "
          f"{h}x{w}, {cfg.num_bins} bins: events + host voxelization "
          f"{t_make:.2f} s (one thread); collate of one batch (pad to "
          f"{FLOW_CAPACITY}, polarity packing, LUT-cell sort, cell_ends) "
          f"{t_collate:.2f} s; {valid} valid events of "
          f"{batch['events'].shape[0] * batch['events'].shape[1]}")
    # The same samples collated without the LUT-cell sort (the DataLoader's
    # default) and without their host voxel: the unsorted path's batches.
    t0 = time.perf_counter()
    unsorted = collate_fixed_capacity(
        [{k: v for k, v in smp.items() if k != "voxel"} for smp in samples],
        FLOW_CAPACITY, polarity_aware=True)
    print(f"[flow-batch] the same samples collated unsorted (pad, polarity "
          f"packing; no sort, no voxel) {time.perf_counter() - t0:.2f} s")
    train = {k: v for k, v in batch.items()
             if k not in ("forward_flow", "flow_valid")}
    unsorted_train = {k: v for k, v in unsorted.items()
                      if k not in ("forward_flow", "flow_valid")}
    return train, batch, unsorted_train, unsorted, samples


def time_kernel(torch, label, k_ms, plain, library, flush, nbytes):
    """The kernels-line numbers of a kernel whose timers' ms is `k_ms`:
    its bytes bound, and its plain version and the library call timed."""
    p_ms = timers(torch, plain, flush, reps=5, warmup=1)[0]
    l_ms = (timers(torch, library, flush, reps=5, warmup=1)[0]
            if library is not None else None)
    bound = nbytes / H100_BYTES_PER_S * 1e3
    lib = f"{l_ms * 1e3:.1f} us" if l_ms is not None else "none"
    print(f"[flow-timing] {label}: kernel={k_ms * 1e3:.1f} us "
          f"bound={bound * 1e3:.1f} us ({nbytes / 1e6:.1f} MB, bytes) "
          f"plain={p_ms * 1e3:.1f} us library={lib}")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": l_ms}


def check_close(label, got, want, rel_tol, tag="flow-kernel-vs-plain"):
    """max |got - want| against rel_tol x max(1, max |want|); fails above
    or on a non-finite kernel result."""
    if not bool(got.isfinite().all()):
        fail(f"{label}: the kernel left non-finite values")
    err = float((got - want).abs().max().item())
    scale = max(1.0, float(want.abs().max().item()))
    tol = rel_tol * scale
    print(f"[{tag}] {label}: max_abs_diff={err:.3e} "
          f"(bound {tol:.3e} = {rel_tol:g} x max(1, max |plain|))")
    if not err <= tol:
        fail(f"{label}: kernel disagrees with plain")
    return err


def phase_flow_kernels(torch, cfg, loss_cfg, batch):
    """Each new kernel against its plain version and timed, at the path's
    shapes.  Returns {kernel name: numbers for the JSON line}."""
    from motionpriorcmax_tpu_torch.losses.focus import lut_indices
    from motionpriorcmax_tpu_torch.ops.cuda import iwe_vote as iv
    from motionpriorcmax_tpu_torch.ops.cuda import lut_gather as lg

    h, w = cfg.image_shape
    npos = batch["num_pos_events"]
    events = torch.from_numpy(batch["events"]).cuda()
    b, m, _ = events.shape
    cases = vote_cases(torch, batch, h, w, loss_cfg.num_bins,
                       loss_cfg.lut_superpixel_size)
    gimg = torch.randn(b, h, w, device="cuda")
    out = {}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    # Vote (rows 3 and 4): the sorted half as the path votes it, the same
    # events in random order, skewed, and with a wide flow (vote_cases);
    # the backward on all four, then on the unsorted events with the
    # cotangent as the path hands it over.
    for name in ("iwe_vote_fwd", "iwe_vote_bwd"):
        out[name] = {}
    same_bits = {}

    def vote_bwd_check(label, c, v, g):
        # d coords against plain; the bits of two calls compared.
        k_dc, _ = iv.iwe_vote_bwd(c, v, g, h, w, need_dweight=False)
        again, _ = iv.iwe_vote_bwd(c, v, g, h, w, need_dweight=False)
        same_bits[label] = torch.equal(k_dc.view(torch.int32),
                                       again.view(torch.int32))
        p_dc, _ = iv.iwe_vote_bwd_plain(c, v, g, h, w, need_dweight=False)
        return check_close(f"iwe_vote_bwd {label}", k_dc, p_dc,
                           TOL_VOTE_BWD)

    for label, (c, v) in cases.items():
        nnz = int((v != 0).sum())
        fwd_bytes = b * npos * 4 + nnz * 8 + b * h * w * 4
        bwd_bytes = b * npos * 4 + nnz * 8 + b * h * w * 4 + b * npos * 8
        k_out = iv.iwe_vote_fwd(c, v, h, w)
        p_out = iv.iwe_vote_fwd_plain(c, v, h, w)
        e_f = check_close(f"iwe_vote_fwd {label} B={b} M={npos} {h}x{w}",
                          k_out, p_out, TOL_VOTE_FWD)
        del k_out, p_out
        share = vote_band_share(iv, c, v, h, w)
        print(f"[flow-kernel-vs-plain] iwe_vote_fwd {label}: {share:.4f} of "
              f"the live taps through the shared-memory band (plain twin)")
        k_ms, card_ms, _ = timers(torch, lambda: iv.iwe_vote_fwd(c, v, h, w),
                                  flush)
        print(f"[flow-timing] iwe_vote_fwd {label}: card time "
              f"{card_ms * 1e3:.1f} us")
        e_b = vote_bwd_check(label, c, v, gimg)
        bwd_ms, bwd_card_ms, _ = timers(
            torch, lambda: iv.iwe_vote_bwd(c, v, gimg, h, w,
                                           need_dweight=False), flush)
        print(f"[flow-timing] iwe_vote_bwd {label}: card time "
              f"{bwd_card_ms * 1e3:.1f} us")
        if label in ("skewed", "wide"):
            print(f"[flow-timing] iwe_vote_fwd {label}: kernel="
                  f"{k_ms * 1e3:.1f} us bound="
                  f"{fwd_bytes / H100_BYTES_PER_S * 1e6:.1f} us")
            out["iwe_vote_fwd"].update({
                f"{label}_ms": k_ms, f"{label}_card_ms": card_ms,
                f"{label}_bound_ms": fwd_bytes / H100_BYTES_PER_S * 1e3,
                f"{label}_max_abs_err": e_f, f"{label}_band_share": share})
            print(f"[flow-timing] iwe_vote_bwd {label}: kernel="
                  f"{bwd_ms * 1e3:.1f} us bound="
                  f"{bwd_bytes / H100_BYTES_PER_S * 1e6:.1f} us")
            out["iwe_vote_bwd"].update({
                f"{label}_ms": bwd_ms, f"{label}_card_ms": bwd_card_ms,
                f"{label}_bound_ms": bwd_bytes / H100_BYTES_PER_S * 1e3,
                f"{label}_max_abs_err": e_b})
            continue
        # The library yardstick: one index_put_(accumulate=True) of the
        # precomputed corner indices and values.
        y1, x1, corners = iv._taps(c, h, w)
        idx, val = [], []
        for dy, dx, wy, wx, mask in corners:
            idx.append(iv._flat_index(y1, x1, dy, dx, mask, h, w).reshape(-1))
            val.append(torch.where(mask, wy * wx * v, 0.0).reshape(-1))
        idx, val = torch.cat(idx), torch.cat(val)
        del y1, x1, corners
        img = torch.zeros(b * h * w, device="cuda")
        f = time_kernel(
            torch, f"iwe_vote_fwd {label}", k_ms,
            lambda: iv.iwe_vote_fwd_plain(c, v, h, w),
            lambda: img.zero_().index_put_((idx,), val, accumulate=True),
            flush, fwd_bytes)
        bw = time_kernel(
            torch, f"iwe_vote_bwd {label}", bwd_ms,
            lambda: iv.iwe_vote_bwd_plain(c, v, gimg, h, w,
                                          need_dweight=False),
            None, flush, bwd_bytes)
        del idx, val, img
        f.update(card_ms=card_ms, band_share=share)
        bw.update(card_ms=bwd_card_ms)
        for name, nums, err in (("iwe_vote_fwd", f, e_f),
                                ("iwe_vote_bwd", bw, e_b)):
            if label == "sorted":
                out[name].update(nums, max_abs_err=err)
            else:
                out[name].update({f"unsorted_{k}": x for k, x in nums.items()
                                  if k not in ("bound_ms", "bound_by")},
                                 unsorted_max_abs_err=err)
    # The unsorted events' backward with the cotangent as autograd hands
    # it to each polarity half of make_iwes' stack: select(1, 0) of a
    # [B, 2, H, W] tensor, a batch stride of 2 H W, read where it lies.
    c, v = cases["unsorted"]
    gsel = torch.randn(b, 2, h, w, device="cuda").select(1, 0)
    e_s = vote_bwd_check("unsorted_strided", c, v, gsel)
    s_card_ms = timers(torch, lambda: iv.iwe_vote_bwd(
        c, v, gsel, h, w, need_dweight=False), flush)[1]
    print(f"[flow-timing] iwe_vote_bwd unsorted_strided: card time "
          f"{s_card_ms * 1e3:.1f} us")
    out["iwe_vote_bwd"].update(unsorted_strided_card_ms=s_card_ms,
                               unsorted_strided_max_abs_err=e_s)
    del c, v, gsel
    differ = [k for k, same in same_bits.items() if not same]
    print(f"[flow-kernel-vs-plain] iwe_vote_bwd: two calls differ in bits "
          f"on {len(differ)} of {len(same_bits)} cases {differ}")
    if differ:
        fail(f"iwe_vote_bwd: two calls gave different bits on {differ}")
    out["iwe_vote_bwd"]["deterministic"] = not differ
    del cases, gimg
    torch.cuda.empty_cache()

    # LUT gather (row 6), the path's indices.
    hq, wq = h // loss_cfg.lut_superpixel_size, w // loss_cfg.lut_superpixel_size
    nb = loss_cfg.num_bins
    lut = torch.randn(b, hq * nb, wq, 2, device="cuda")
    rows, cols = lut_indices(loss_cfg, events, nb, sorted_layout=True)
    cells = hq * nb * wq
    e_g = check_close(f"lut_gather_fwd B={b} M={m} LUT {tuple(lut.shape[1:])}",
                      lg.lut_gather_fwd(lut, rows, cols),
                      lg.lut_gather_plain(lut, rows, cols), 0.0)
    flat = (torch.arange(b, device="cuda")[:, None] * cells
            + rows.long() * wq + cols.long()).reshape(-1)
    lut_flat = lut.reshape(-1, 2)
    out["lut_gather_fwd"] = time_kernel(
        torch, "lut_gather_fwd",
        timers(torch, lambda: lg.lut_gather_fwd(lut, rows, cols), flush)[0],
        lambda: lg.lut_gather_plain(lut, rows, cols),
        lambda: lut_flat[flat], flush,
        b * m * 8 + b * m * 2 * 4 + lut.numel() * 4)
    out["lut_gather_fwd"]["max_abs_err"] = e_g
    del lut, lut_flat, rows, cols

    # Its sorted segment sum (row 6) on the path's batch, a skewed one and
    # at the traj-train shape (segsum_cases); two calls must give the same
    # bits.
    out["lut_segsum_bwd"] = {"deterministic": True}
    for label, (gev, ends, n_cells) in segsum_cases(torch, batch,
                                                    loss_cfg).items():
        segs = ends.shape[1] // n_cells
        got = lg.lut_segsum_bwd(gev, ends, n_cells)
        again = lg.lut_segsum_bwd(gev, ends, n_cells)
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            fail(f"lut_segsum_bwd {label}: two calls gave different bits")
        err = check_close(
            f"lut_segsum_bwd {label} B={gev.shape[0]} M={gev.shape[1]} "
            f"S={segs} x {n_cells} cells (identical bits in two calls)",
            got, lg.lut_segsum_plain(gev, ends, n_cells), TOL_SEGSUM)
        del got, again
        nbytes = (gev.numel() * 4 + ends.numel() * 4
                  + gev.shape[0] * n_cells * 2 * 4)
        k_ms, card_ms, _ = timers(
            torch, lambda: lg.lut_segsum_bwd(gev, ends, n_cells), flush)
        print(f"[flow-timing] lut_segsum_bwd {label}: card time "
              f"{card_ms * 1e3:.1f} us")
        if label == "sorted":
            dl = torch.zeros(b * cells, 2, device="cuda")
            gflat = gev.reshape(-1, 2)
            nums = time_kernel(
                torch, "lut_segsum_bwd", k_ms,
                lambda: lg.lut_segsum_plain(gev, ends, n_cells),
                lambda: dl.zero_().index_add_(0, flat, gflat), flush, nbytes)
            nums.update(max_abs_err=err, card_ms=card_ms)
            del dl, gflat
        else:
            bound = nbytes / H100_BYTES_PER_S * 1e3
            print(f"[flow-timing] lut_segsum_bwd {label}: kernel="
                  f"{k_ms * 1e3:.1f} us bound={bound * 1e3:.1f} us "
                  f"({nbytes / 1e6:.1f} MB, bytes)")
            nums = {f"{label}_ms": k_ms, f"{label}_bound_ms": bound,
                    f"{label}_max_abs_err": err,
                    f"{label}_card_ms": card_ms}
        out["lut_segsum_bwd"].update(nums)
        del gev, ends
    del events, flat, flush
    torch.cuda.empty_cache()
    return out


def sm_clock_hz() -> float:
    """The card's maximum SM clock as nvidia-smi reports it."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


def sdpa_yardstick(torch, queries, db, vals, temp):
    """F.scaled_dot_product_attention computing the same softmax with no
    band: Q = [qy, qx, 1], K = [2 dy, 2 dx, -|d|^2] / temp, V = vals (head
    dim padded to 8 with zeros), scale 1.  Returns a callable."""
    from torch.nn import functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    g, n, c = vals.shape
    q = queries.shape[0]
    qq = torch.zeros(g, 1, q, 8, device="cuda")
    qq[..., 0], qq[..., 1], qq[..., 2] = queries[:, 0], queries[:, 1], 1.0
    kk = torch.zeros(g, 1, n, 8, device="cuda")
    kk[..., 0] = 2 * db[..., 0][:, None] / temp
    kk[..., 1] = 2 * db[..., 1][:, None] / temp
    kk[..., 2] = -(db * db).sum(-1)[:, None] / temp
    vv = torch.zeros(g, 1, n, 8, device="cuda")
    vv[..., :c] = vals[:, None]

    def run():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(qq, kk, vv, scale=1.0)
    return run


def softmax_bound(torch, pairs, c, q, g, n, fwd):
    """(bound ms, "operations" or "bytes", its three parts in ms) of one
    pass over `pairs` (query, slot) pairs: one exp2 per pair on the SFUs
    (16 per SM per clock), f32 instructions at 128 per SM per clock (fwd:
    sub, sub, mul, fma, the denominator add and C fmas; bwd the same but
    the add), and the bytes each input and output moves once."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = sm_clock_hz()
    exp2_ms = pairs / (16 * sms * clock) * 1e3
    f32_ms = pairs * ((5 if fwd else 4) + c) / (128 * sms * clock) * 1e3
    nbytes = (q * 8 + g * n * (8 + 4 * c) + g * q * 4 * (c + 1) if fwd else
              q * 8 + g * n * 8 + g * q * 4 * c + g * n * 4 * c)
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    bound = max(exp2_ms, f32_ms, bytes_ms)
    unit = ("exp2" if bound == exp2_ms else
            "f32" if bound == f32_ms else "bytes")
    return bound, unit, {"exp2_ms": exp2_ms, "f32_ms": f32_ms,
                         "bytes_ms": bytes_ms, "sms": sms, "clock": clock}


def softmax_cut_sweep(torch, si):
    """One query against db points at prescaled squared distances 120 to
    160 (steps of 1/64, one group each), vals = gs = 1: the kernels' den
    and d vals are each pair's weight.  Fails when a weight from d2 >=
    CUT - 1 on is nonzero (the kernels compute exp2 up to CUT, so the cut
    leaves out only zeros), when a weight that the plain version makes
    nonzero is 0 in the kernel (a pair the cull dropped), when a kernel
    weight differs from the plain one at all, or when the forward's and
    the backward's weights differ.  Returns {exp_dtype: the largest d2
    with a nonzero weight}."""
    temp = 25.0
    rscale = si._prescale(temp)
    d2 = torch.arange(120 * 64, 160 * 64, device="cuda",
                      dtype=torch.float64) / 64
    g = d2.shape[0]
    queries = torch.zeros(1, 2, device="cuda")
    db = torch.zeros(g, 1, 2, device="cuda")
    db[:, 0, 0] = (d2.sqrt() / rscale).float()
    ones = torch.ones(g, 1, 1, device="cuda")
    slots = si.scan_slots(queries, (0.0, 0.0, 0.0), g, 1)
    got = (db[:, 0, 0] * rscale).double() ** 2     # the squared distances
    last = {}
    for exp_dtype in ("float32", "bfloat16"):
        _, den = si.softmax_interp_fwd(queries, db, ones, temp, slots,
                                       exp_dtype)
        dv = si.softmax_interp_bwd(queries, db, ones, temp, slots, exp_dtype)
        _, den_p = si.softmax_interp_fwd_plain(queries, db, ones, temp,
                                               slots, exp_dtype)
        w = den[:, 0]
        live = w != 0
        top = float(got[live].max()) if bool(live.any()) else float("nan")
        beyond = int((live & (got >= si.CUT - 1)).sum())
        dropped = int(((den_p[:, 0] != 0) & ~live).sum())
        same = torch.equal(w, dv[:, 0, 0])
        rel = float(((w - den_p[:, 0]).abs()
                     / den_p[:, 0].abs().clamp(min=1e-45)).max())
        print(f"[softmax-kernels] cut sweep {exp_dtype}: {g} squared "
              f"distances 120-160, the largest with a nonzero kernel weight "
              f"{top:.4f}; nonzero weights from {si.CUT - 1:g} on: {beyond} "
              f"(cut {si.CUT:g}); nonzero plain weights that the kernel "
              f"makes 0: {dropped}; fwd den and bwd d vals "
              f"{'equal' if same else 'differ'}; largest relative "
              f"difference to the plain weights {rel:.3e}")
        if beyond or dropped or rel != 0 or not same:
            fail(f"softmax cut sweep {exp_dtype}: a nonzero weight near the "
                 f"cut, a dropped or changed weight, or the two kernels' "
                 f"weights differ")
        last[exp_dtype] = top
    return last


def softmax_check(torch, si, label, case, sub, seed):
    """Row 7's kernels on one of softmax_cases against their plain versions
    on the groups `sub` (TOL_SOFTMAX), the backward's bits in two calls,
    and the (query, slot) pairs: scanned, needed (nonzero f32 weight), and
    computed, counted by the kernels' counting build (which must give the
    same values) beside the count of their partition's PyTorch twin
    (cull_pairs).  Fails on a disagreement.  Returns (out, gs, {numbers}):
    gs = a seeded cotangent over max(den, 1e-30)."""
    queries, db, vals, slots, temp = case
    g, n, c = vals.shape
    q = queries.shape[0]
    k_out, k_den = si.softmax_interp_fwd(queries, db, vals, temp, slots)
    p_out, p_den = si.softmax_interp_fwd_plain(queries, db[sub], vals[sub],
                                               temp, slots[sub])
    e_f = check_close(f"softmax_interp_fwd {label} G={g} Q=N={q} C={c} "
                      f"(groups {sub.tolist()} vs plain)", k_out[sub], p_out,
                      TOL_SOFTMAX)
    check_close(f"softmax_interp_fwd {label} den", k_den[sub], p_den,
                TOL_SOFTMAX)
    del p_out, p_den
    gout = torch.randn(g, q, c, device="cuda",
                       generator=torch.Generator(device="cuda")
                       .manual_seed(seed))
    gs = (gout / torch.clamp(k_den, min=1e-30)[..., None]).contiguous()
    del gout
    k_dv = si.softmax_interp_bwd(queries, db, gs, temp, slots)
    same = torch.equal(k_dv.view(torch.int32), si.softmax_interp_bwd(
        queries, db, gs, temp, slots).view(torch.int32))
    print(f"[softmax-kernels] softmax_interp_bwd {label}: two calls "
          f"{'give the same bits' if same else 'differ'}")
    if not same:
        fail(f"softmax_interp_bwd is not deterministic ({label})")
    p_dv = si.softmax_interp_bwd_plain(queries, db[sub], gs[sub], temp,
                                       slots[sub])
    e_b = check_close(f"softmax_interp_bwd {label} (same groups)", k_dv[sub],
                      p_dv, TOL_SOFTMAX)
    del p_dv
    torch.cuda.empty_cache()

    twin = si.cull_pairs(queries, db, slots, temp)
    counts = torch.zeros(2, 1, dtype=torch.int64, device="cuda")
    c_out, c_den = si.softmax_interp_fwd(queries, db, vals, temp, slots,
                                         pairs=counts[0])
    c_dv = si.softmax_interp_bwd(queries, db, gs, temp, slots,
                                 pairs=counts[1])
    counted_same = (torch.equal(c_out, k_out) and torch.equal(c_den, k_den)
                    and torch.equal(c_dv, k_dv))
    del c_out, c_den, c_dv, k_den, k_dv
    fwd_pairs, bwd_pairs = (int(x) for x in counts.view(-1).tolist())
    needed = twin["needed"]
    print(f"[softmax-kernels] {label}: {twin['scanned']:.4g} (query, slot) "
          f"pairs scanned per pass, {twin['scanned'] / (g * q * n):.3f} of "
          f"the dense {g * q * n:.4g}; needed (nonzero f32 weight) "
          f"{needed:.4g} ({needed / twin['scanned']:.4f} of the scanned); "
          f"computed, by the kernels' counters: forward {fwd_pairs:.4g} "
          f"({fwd_pairs / needed:.2f}x needed), backward {bwd_pairs:.4g} "
          f"({bwd_pairs / needed:.2f}x); the twin's count of the partition "
          f"{twin['computed_fwd']:.4g} / {twin['computed_bwd']:.4g}; the "
          f"counting build's values "
          f"{'equal' if counted_same else 'differ from'} the kernels'")
    if not counted_same:
        fail(f"softmax_interp counting build: other values ({label})")
    if min(fwd_pairs, bwd_pairs) < needed:
        fail(f"softmax_interp {label}: the kernels computed fewer pairs "
             f"than have a nonzero weight")
    if (fwd_pairs, bwd_pairs) != (twin["computed_fwd"], twin["computed_bwd"]):
        fail(f"softmax_interp {label}: the twin's partition counts "
             f"{twin['computed_fwd']} / {twin['computed_bwd']} pairs, the "
             f"kernels {fwd_pairs} / {bwd_pairs}")
    return k_out, gs, {"max_abs_err_fwd": e_f, "max_abs_err_bwd": e_b,
                       "scanned_pairs": twin["scanned"],
                       "needed_pairs": needed,
                       "computed_pairs_fwd": fwd_pairs,
                       "computed_pairs_bwd": bwd_pairs}


def phase_softmax_kernels(torch, loss_cfg, batch):
    """Rows 7 (fwd, bwd) and 8 against their plain versions at the
    softmax / device-voxelize path's shapes, then timed.  Returns {kernel
    name: numbers for the JSON line}."""
    from motionpriorcmax_tpu_torch.ops.cuda import softmax_interp as si
    from motionpriorcmax_tpu_torch.ops.cuda import voxel_vote as vv

    out = {}
    h, w = loss_cfg.image_shape
    nb = loss_cfg.num_bins
    b = batch["events"].shape[0]
    sweep = softmax_cut_sweep(torch, si)
    cases = softmax_cases(torch, loss_cfg, softmax_loss_cfgs()[1])
    # The plain versions hold one dense [Q, N] matrix per group: 4 groups
    # (the first and last bin of two samples) against the kernels' G.
    queries, db, vals, slots, temp = cases["flow"]
    g, n, c = vals.shape
    q = queries.shape[0]
    sub = torch.tensor([0, nb - 1, g - nb, g - 1], device="cuda")
    k_out, gs, checked = softmax_check(torch, si, "flow", cases["flow"], sub,
                                       22)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    lib = sdpa_yardstick(torch, queries, db, vals, temp)
    try:
        # Against the kernel without band, which scans what SDPA sums: the
        # difference is SDPA's expansion-form logits (and its max shift).
        sdpa_out = lib()[:, 0, :, :c]
        full_slots = si.scan_slots(queries, (0.0, 0.0, 0.0), g, n)
        full_out, _ = si.softmax_interp_fwd(queries, db, vals, temp,
                                            full_slots)
        sdpa_err = float((sdpa_out - full_out).abs().max())
        print(f"[softmax-kernels] scaled_dot_product_attention vs the "
              f"kernel without band: max_abs_diff={sdpa_err:.3e}; the band "
              f"changes the kernel's output by "
              f"{float((full_out - k_out).abs().max()):.3e}")
        del sdpa_out, full_out, full_slots
    except RuntimeError as exc:          # no SDPA backend for these inputs
        print(f"[softmax-timing] scaled_dot_product_attention refused: {exc}")
        lib, sdpa_err = None, None
    del k_out
    for name, fwd, fn, plain, library in (
            ("softmax_interp_fwd", True,
             lambda: si.softmax_interp_fwd(queries, db, vals, temp, slots),
             lambda: si.softmax_interp_fwd_plain(queries, db, vals, temp,
                                                 slots),
             lib),
            ("softmax_interp_bwd", False,
             lambda: si.softmax_interp_bwd(queries, db, gs, temp, slots),
             lambda: si.softmax_interp_bwd_plain(queries, db, gs, temp,
                                                 slots),
             None)):
        k_ms, kc_ms, _ = timers(torch, fn, flush, reps=10, warmup=2)
        p_ms = timers(torch, plain, flush, reps=1, warmup=1)[0]
        l_ms = (timers(torch, library, flush, reps=3, warmup=1)[0]
                if library is not None else None)
        needed = checked["needed_pairs"]
        bound, unit, parts = softmax_bound(torch, needed, c, q, g, n, fwd)
        old, _, _ = softmax_bound(torch, checked["scanned_pairs"], c, q, g, n,
                                  fwd)
        computed = checked["computed_pairs_fwd" if fwd else
                           "computed_pairs_bwd"]
        lib_txt = (f"{l_ms * 1e3:.1f} us (dense, no band; max |diff| to "
                   f"the unbanded kernel {sdpa_err:.3e})" if l_ms is not None
                   else "none")
        print(f"[softmax-timing] {name}: kernel={k_ms * 1e3:.1f} us "
              f"(card {kc_ms * 1e3:.1f} us) bound={bound * 1e3:.1f} us over "
              f"the {needed:.4g} needed pairs, {unit} (exp2 "
              f"{parts['exp2_ms'] * 1e3:.1f} us at 16/SM/clk, f32 "
              f"{parts['f32_ms'] * 1e3:.1f} us at 128/SM/clk, {parts['sms']} "
              f"SMs at {parts['clock'] / 1e6:.0f} MHz; bytes "
              f"{parts['bytes_ms'] * 1e3:.1f} us; over the scanned pairs "
              f"{old * 1e3:.1f} us) plain={p_ms * 1e3:.1f} us "
              f"library={lib_txt}")
        out[name] = {"ms": k_ms, "card_ms": kc_ms, "plain_ms": p_ms,
                     "bound_ms": bound,
                     "bound_by": "bytes" if unit == "bytes" else "operations",
                     "bound_unit": unit, "bound_scanned_ms": old,
                     "library_ms": l_ms,
                     "max_abs_err": checked["max_abs_err_fwd" if fwd else
                                            "max_abs_err_bwd"],
                     "scanned_pairs": checked["scanned_pairs"],
                     "needed_pairs": needed,
                     "computed_pairs": computed,
                     "cut_sweep_top_d2": sweep}
    out["softmax_interp_fwd"]["library_max_abs_diff"] = sdpa_err
    out["softmax_interp_bwd"]["deterministic"] = True
    del queries, db, vals, slots, gs, lib
    torch.cuda.empty_cache()

    # The traj-train softmax step's shapes (phase 22's): checked the same
    # way, on the first and last bin of two samples, then timed.
    case = cases.pop("traj")
    del cases
    queries, db, vals, slots, temp = case
    g, n, c = vals.shape
    q = queries.shape[0]
    bins = g // TRAIN_BATCH
    sub = torch.tensor([0, bins - 1, g - bins, g - 1], device="cuda")
    _, gs, checked = softmax_check(torch, si, "traj", case, sub, 24)
    del case
    torch.cuda.empty_cache()
    for name, fwd, fn in (
            ("softmax_interp_fwd", True,
             lambda: si.softmax_interp_fwd(queries, db, vals, temp, slots)),
            ("softmax_interp_bwd", False,
             lambda: si.softmax_interp_bwd(queries, db, gs, temp, slots))):
        k_ms, kc_ms, _ = timers(torch, fn, flush, reps=10, warmup=2)
        bound, unit, _ = softmax_bound(torch, checked["needed_pairs"], c, q,
                                       g, n, fwd)
        computed = checked["computed_pairs_fwd" if fwd else
                           "computed_pairs_bwd"]
        print(f"[softmax-timing] {name} traj-train shape G={g} Q=N={q} C={c}"
              f": kernel={k_ms * 1e3:.1f} us (card {kc_ms * 1e3:.1f} us) "
              f"bound={bound * 1e3:.1f} us ({unit}); pairs scanned "
              f"{checked['scanned_pairs']:.4g}, needed "
              f"{checked['needed_pairs']:.4g}, computed {computed:.4g}")
        out[name].update(
            traj_ms=k_ms, traj_card_ms=kc_ms, traj_bound_ms=bound,
            traj_max_abs_err=checked["max_abs_err_fwd" if fwd else
                                     "max_abs_err_bwd"],
            traj_scanned_pairs=checked["scanned_pairs"],
            traj_needed_pairs=checked["needed_pairs"],
            traj_computed_pairs=computed)
    del queries, db, vals, slots, gs
    torch.cuda.empty_cache()

    # Row 8: the step's events (cell-sorted per polarity half), the same
    # events in random order, and the same events skewed.
    events = torch.from_numpy(batch["events"]).cuda()
    m = events.shape[1]
    perm = torch.argsort(torch.rand(b, m, device="cuda"), dim=1)
    unsorted = torch.gather(events, 1, perm[..., None].expand(-1, -1, 6))
    del perm
    skewed = torch.from_numpy(skewed_events(batch["events"], h, w, 14)).cuda()
    ty, tx = vv.voxel_tile_shape(nb, h, w)
    print(f"[softmax-kernels] voxel_vote tiles {nb} bins x {ty} x {tx} px; "
          f"skewed batch: per sample half the live events in one 16x64 "
          f"region, 1% on one pixel")
    nbytes = events.numel() * 4 + b * nb * h * w * 4
    img = torch.zeros(b * nb * h * w, device="cuda")
    for label, ev in (("sorted", events), ("unsorted", unsorted),
                      ("skewed", skewed)):
        err = check_close(f"voxel_vote {label} B={b} M={m} {nb}x{h}x{w}",
                          vv.voxel_vote(ev, nb, h, w),
                          vv.voxel_vote_plain(ev, nb, h, w), TOL_VOXEL)
        k_ms, kc_ms, _ = timers(torch, lambda: vv.voxel_vote(ev, nb, h, w),
                                flush)
        print(f"[flow-timing] voxel_vote {label}: card time {kc_ms * 1e3:.1f}"
              f" us (the card spun while the host enqueued the call)")
        if label == "skewed":
            print(f"[flow-timing] voxel_vote skewed: kernel={k_ms * 1e3:.1f} "
                  f"us ({k_ms / out['voxel_vote']['unsorted_ms']:.2f}x the "
                  f"unsorted batch)")
            out["voxel_vote"].update(skewed_ms=k_ms, skewed_card_ms=kc_ms,
                                     skewed_max_abs_err=err)
            continue
        idx, val = vv.voxel_taps(ev, nb, h, w)
        idx, val = idx.reshape(-1), val.reshape(-1)
        nums = time_kernel(
            torch, f"voxel_vote {label}", k_ms,
            lambda: vv.voxel_vote_plain(ev, nb, h, w),
            lambda: img.zero_().index_add_(0, idx, val), flush, nbytes)
        if label == "sorted":
            out["voxel_vote"] = dict(nums, max_abs_err=err, card_ms=kc_ms)
        else:
            out["voxel_vote"].update(unsorted_ms=nums["ms"],
                                     unsorted_card_ms=kc_ms,
                                     unsorted_plain_ms=nums["plain_ms"],
                                     unsorted_library_ms=nums["library_ms"],
                                     unsorted_max_abs_err=err)
        del idx, val
    del events, unsorted, skewed, img, flush
    # Events on tile edges and corners and at the clamp limits, B=3 with a
    # ragged M: every output element written, within TOL_VOXEL.
    edge = torch.from_numpy(edge_events(3, 40_001, h, w, ty, tx, 15)).cuda()
    err = check_close(f"voxel_vote edges B=3 M=40001 {nb}x{h}x{w}",
                      vv.voxel_vote(edge, nb, h, w),
                      vv.voxel_vote_plain(edge, nb, h, w), TOL_VOXEL)
    out["voxel_vote"]["edge_max_abs_err"] = err
    del edge
    torch.cuda.empty_cache()
    return out


def edge_events(b, m, h, w, ty, tx, seed):
    """Events on tile edges (y, x on and next to multiples of ty, tx),
    on corners, at the clamp limits -3 and size + 2, at size - 1 and -1,
    at bin edges, and padding rows."""
    rng = np.random.default_rng(seed)
    y = rng.uniform(-3.5, h + 2.5, (b, m))
    x = rng.uniform(-3.5, w + 2.5, (b, m))
    t = rng.uniform(0, 1, (b, m))
    k = m // 4
    y[:, :k] = (rng.integers(0, h // ty + 1, (b, k)) * ty
                + rng.choice([0.0, -1.0, -0.5, -1e-3], (b, k)))
    x[:, k // 2:3 * k // 2] = (rng.integers(0, w // tx + 1, (b, k)) * tx
                               + rng.choice([0.0, -1.0, -0.25], (b, k)))
    lim = rng.choice([-3.0, -1.0, -0.5, 2.0], (b, k))
    y[:, 2 * k:3 * k] = np.where(lim > 0, h + lim, lim)
    x[:, 2 * k + k // 2:3 * k + k // 2] = np.where(
        rng.random((b, k)) < 0.5, w + 2.0, -3.0)
    t[:, 3 * k:3 * k + k // 4] = rng.choice([0.0, 1.0, 0.5], (b, k // 4))
    p = rng.integers(0, 2, (b, m))
    valid = (rng.random((b, m)) > 0.05).astype(np.float64)
    return np.stack([y, x, t, p, np.zeros((b, m)), valid],
                    -1).astype(np.float32)


FLOW_KERNELS = ("iwe_vote_fwd", "iwe_vote_bwd", "lut_gather_fwd",
                "lut_segsum_bwd")
# The BatchNorms (ops/cuda/flax_batch_norm.py) of the UNet (18, each with
# its ReLU fused) and of RAFT-Spline's context encoder (15; the feature
# encoders' norms are instance norms).
UNET_NORMS, RAFT_NORMS = 18, 15


def bn_launches(norms, train):
    """Launches of `norms` BatchNorms: in train mode 2 + 2 reduce launches
    (the forward's sums, the backward's) and 1 + 1 apply launches each, in
    eval mode 1 apply launch each."""
    return {"flax_bn_reduce": 4 * norms if train else 0,
            "flax_bn_apply": (2 if train else 1) * norms}


SOFTMAX_KERNELS = ("softmax_interp_fwd", "softmax_interp_bwd", "voxel_vote")
# Launches per train step and in the val pass (one batch) of the two
# flow-train paths; the exact KNN's kernel once per focus loss.
EXACT_STEP = {"iwe_vote_fwd": 2, "iwe_vote_bwd": 2, "lut_gather_fwd": 1,
              "lut_segsum_bwd": 1, "softmax_interp_fwd": 0,
              "softmax_interp_bwd": 0, "voxel_vote": 0,
              "grid_segment_sum": 0, "knn_topk": 1,
              **bn_launches(UNET_NORMS, True)}
EXACT_VAL = {**EXACT_STEP, "iwe_vote_bwd": 0, "lut_segsum_bwd": 0,
             **bn_launches(UNET_NORMS, False)}
# knn_method grid: the window KNN, plain PyTorch, in place of the kernel.
GRID_STEP = {**EXACT_STEP, "knn_topk": 0}
GRID_VAL = {**EXACT_VAL, "knn_topk": 0}
SOFTMAX_STEP = {**EXACT_STEP, "softmax_interp_fwd": 1,
                "softmax_interp_bwd": 1, "voxel_vote": 1, "knn_topk": 0}
SOFTMAX_VAL = {**SOFTMAX_STEP, "iwe_vote_bwd": 0, "lut_segsum_bwd": 0,
               "softmax_interp_bwd": 0, **bn_launches(UNET_NORMS, False)}
# The softmax / device-voxel step on unsorted events: no LUT-gather kernels
# (row 6), the any-order segment sum (row 5) in their place, and the vote
# (row 4) and voxel vote (row 8) on events in any order.
UNSORTED_STEP = {**SOFTMAX_STEP, "lut_gather_fwd": 0, "lut_segsum_bwd": 0,
                 "grid_segment_sum": 1}
UNSORTED_VAL = {**SOFTMAX_VAL, "lut_gather_fwd": 0}


def launch_counts():
    """{wrapper: kernel launches} of every ops/cuda wrapper since the last
    profiling.reset(): the launches.<wrapper> counters of
    profiling.snapshot()."""
    from motionpriorcmax_tpu_torch.utils import profiling

    return {name[len("launches."):]: n for name, n in
            profiling.snapshot()["counters"].items()
            if name.startswith("launches.")}


def launched(counts):
    """The wrappers of `counts` that launched: a launch table's zeros and
    the wrappers it leaves out both mean none."""
    return {k: v for k, v in counts.items() if v}


def phase_flow_train(torch, cfg, loss_cfg, train_batch, val_batch, smi_line,
                     want, val_want, tag="flow-train", state=None,
                     want_losses=None, n_steps=FLOW_STEPS, mesh=None):
    """train_flow at full width: 1 warm-up + `n_steps` - 1 timed steps, one
    val pass, a checkpoint; `state` is the train state to start from (else
    one made from seed 0); with `mesh` (a world of one), train_flow's
    sharded path, and the bytes each step all-reduces.  Fails unless every
    step launches `want` and the val pass `val_want`.  Returns (the
    kernels' launch counts over the run, mean step ms)."""
    import tempfile

    from motionpriorcmax_tpu_torch.training.loop import train_flow
    from motionpriorcmax_tpu_torch.utils import profiling

    marks = []          # (time, launch counts) at every step boundary

    reduced = []        # the mesh's all-reduced bytes at each boundary

    def mark():
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), launch_counts()))
        if mesh is not None:
            reduced.append(mesh.reduced_bytes)

    def timed_batches():
        for _ in range(n_steps):
            mark()
            yield train_batch
        mark()

    npos = train_batch["num_pos_events"]
    with tempfile.TemporaryDirectory() as workdir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        profiling.reset()
        train_flow(cfg, loss_cfg, timed_batches(), [val_batch], workdir,
                   device="cuda", max_epochs=1, num_pos_events=npos,
                   log_every=1, seed=0, resume_state=state, mesh=mesh)
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        with open(f"{workdir}/scalars.jsonl") as fh:
            recs = [json.loads(line) for line in fh]
        ckpts = sorted(p for p in os.listdir(f"{workdir}/checkpoints")
                       if p.endswith(".pt"))
    steps = []
    for (t0, c0), (t1, c1) in zip(marks[:-1], marks[1:]):
        steps.append((t1 - t0, {k: c1[k] - c0[k] for k in c0}))
    losses = [r["train_losses/total"] for r in recs
              if "train_losses/total" in r]
    epe = [r["val_losses/EPE"] for r in recs if "val_losses/EPE" in r]
    b, m = train_batch["events"].shape[:2]
    valid = float(train_batch["events"][..., 5].sum())
    for i, (dt, counts) in enumerate(steps):
        print(f"[{tag}] step {i}{' (warm-up)' if i == 0 else ''}: "
              f"{dt * 1e3:.1f} ms (host batch to logged loss), loss "
              f"{losses[i]:.6f}, launches {launched(counts)}")
    if any(launched(counts) != launched(want) for _, counts in steps):
        fail(f"expected {launched(want)} launches per step, got "
             f"{[launched(c) for _, c in steps]}")
    in_val = {k: launches[k] - sum(c[k] for _, c in steps) for k in launches}
    if launched(in_val) != launched(val_want):
        fail(f"expected {launched(val_want)} launches in the val pass, got "
             f"{launched(in_val)}")
    if len(losses) != n_steps or not all(np.isfinite(losses)):
        fail(f"train losses {losses}")
    if len(set(losses)) < 2:
        fail(f"the loss did not change between steps: {losses}")
    if want_losses is not None:
        if len(losses) < len(want_losses):
            fail(f"{len(losses)} step losses, fewer than the "
                 f"{len(want_losses)} recorded ones to hold them against")
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
        print(f"[{tag}] losses against the recorded ones {list(want_losses)}: "
              f"max rel diff {rel:.2e} (bound {TOL_STEP_LOSS:g})")
        if not rel <= TOL_STEP_LOSS:
            fail(f"the step losses {losses} moved from {want_losses}")
    if not epe or not np.isfinite(epe[0]):
        fail(f"val EPE {epe}")
    if not ckpts:
        fail("no checkpoint written")
    timed = [dt for dt, _ in steps[1:]]
    mean = float(np.mean(timed))
    if mesh is not None:
        per_step = set(np.diff(reduced).tolist())
        print(f"[{tag}] bytes all-reduced per step {sorted(per_step)} "
              f"(world {mesh.world}, backend {mesh.backend})")
        if len(per_step) != 1 or not per_step.pop() > 0:
            fail(f"the steps all-reduced {np.diff(reduced).tolist()} bytes")
    h, w = cfg.image_shape
    print(f"[{tag}] dsec.yaml B={b} {h}x{w} {cfg.compute_dtype} UNet, "
          f"knn_method {loss_cfg.knn_method}, "
          f"{'host' if 'voxel' in train_batch else 'device'} voxel, "
          f"capacity {m}: "
          f"step mean {mean * 1e3:.1f} ms over {len(timed)} steps "
          f"({', '.join(f'{x * 1e3:.1f}' for x in timed)}), "
          f"{b * m / mean:.4g} events/s padded ({valid / mean:.4g} valid), "
          f"peak memory {peak / 2**30:.2f} GiB; val pass EPE {epe[0]:.4f} "
          f"(launches {launched(in_val)}); checkpoints {ckpts}; card "
          f"{smi_line}")
    return launches, mean * 1e3


def phase_flow_card_vs_cpu(torch, loss_overrides=None, device_voxel=False,
                           want=EXACT_STEP, tag="flow-card-vs-cpu",
                           cell_sort=True):
    """One f32 train_step at the test geometry on the CPU (plain versions)
    and on the card (kernels), same weights, batch and t_ref; with
    `device_voxel` the batch carries no 'voxel', without `cell_sort` no
    'lut_cell_ends' (events in collate order)."""
    from motionpriorcmax_tpu_torch.data.collate import collate_fixed_capacity
    from motionpriorcmax_tpu_torch.training import trajectory_net as ttn
    from motionpriorcmax_tpu_torch.training.loop import to_device

    h, w, nb = 32, 48, 15
    cfg, loss_cfg = flow_configs(
        {**DSEC_CONFIG, "common": {**DSEC_CONFIG["common"], "height": h,
                                   "width": w},
         "loss": {**DSEC_CONFIG["loss"], **(loss_overrides or {})}},
        compute_dtype="float32", unet_widths=[8, 16, 16, 32, 32])
    batch = collate_fixed_capacity(
        flow_samples(3, 2, 2500, h, w, nb), 4096, polarity_aware=True,
        lut_cell_sort_params=((h, w), nb, loss_cfg.lut_superpixel_size)
        if cell_sort else None)
    if device_voxel:
        del batch["voxel"]
    times = torch.cat([torch.tensor([0.37]),
                       (torch.arange(nb) + 0.5) / nb]).float()
    want = {**want, **bn_launches(UNET_NORMS, True)}
    before = launch_counts()
    results = {}
    for dev in ("cpu", "cuda"):
        state = ttn.create_train_state(cfg, dev,
                                       torch.Generator().manual_seed(1))
        logs = ttn.train_step(state, to_device(batch, torch.device(dev)),
                              None, cfg, loss_cfg, batch["num_pos_events"],
                              times=times)
        results[dev] = (float(logs["train_losses/total"]),
                        {n: p.grad.detach().cpu() for n, p in
                         state.model.named_parameters()},
                        {n: b.detach().cpu() for n, b in
                         state.model.named_buffers() if "running" in n})
    launches = {k: n - before[k] for k, n in launch_counts().items()}
    (l_c, g_c, s_c), (l_g, g_g, s_g) = results["cpu"], results["cuda"]
    loss_rel = abs(l_g - l_c) / abs(l_c)
    grad_rel = max(float((g_g[n] - g_c[n]).abs().max()
                         / g_c[n].abs().max().clamp(min=1e-30)) for n in g_c)
    bn_rel = max(float((s_g[n] - s_c[n]).abs().max()
                       / s_c[n].abs().max().clamp(min=1e-30)) for n in s_c)
    print(f"[{tag}] f32 train_step {h}x{w} B=2, knn_method "
          f"{loss_cfg.knn_method}, {'device' if device_voxel else 'host'} "
          f"voxel, {'cell-sorted' if cell_sort else 'unsorted'} events: "
          f"loss rel diff "
          f"{loss_rel:.3e} (bound {TOL_TRAIN_LOSS:g}), gradients max "
          f"|diff| / max |grad| per tensor {grad_rel:.3e} (bound "
          f"{TOL_TRAIN_GRAD:g}), BN statistics max |diff| / max |stat| per "
          f"buffer {bn_rel:.3e} (bound "
          f"{TOL_TRAIN_BN:g}); card launches {launched(launches)}")
    if not (loss_rel <= TOL_TRAIN_LOSS and grad_rel <= TOL_TRAIN_GRAD
            and bn_rel <= TOL_TRAIN_BN):
        fail("card and CPU train steps disagree")
    if launched(launches) != launched(want):
        fail(f"the card's train step launched {launched(launches)}, not "
             f"{launched(want)}")


# ---------------------------------------------------------------------------
# traj-train: RAFT-Spline training (Tab2L5 experiment), corr-window backward
# ---------------------------------------------------------------------------

# The one-cycle schedule's length: the 5 steps the recorded
# TRAJ_SOFTMAX_STEP_LOSSES were taken over (the run stops after TRAIN_STEPS).
TRAJ_SCHEDULE_STEPS = 5
GT_STEPS_SUPERVISED = 5         # MultiFlow: 500 ms at a 100 ms GT cadence
# The backward kernel against its plain version: both sum in f32, the
# kernel with fused multiply-adds and another order; a bf16 d corr is that
# sum rounded once, so the two may sit one bf16 step apart (a step is at
# most 2^-7 of the value: 8 significant bits).
TOL_BWD = 1e-5                  # relative to max(1, max |plain|)
TOL_BWD_BF16 = 2.0 ** -7        # bf16 d corr, relative likewise
# Launches per train step and in the val pass (one batch of 4) of the
# traj-train paths: 12 iterations, one forward launch for all 4 pyramid
# levels and one backward launch per level.
TRAJ_STEP = {"corr_window_lookup": 12, "corr_window_lookup_bwd": 48,
             **EXACT_STEP, **bn_launches(RAFT_NORMS, True)}
TRAJ_VAL = {"corr_window_lookup": 12, **bn_launches(RAFT_NORMS, False)}
TRAJ_SOFTMAX_STEP = {**TRAJ_STEP, "softmax_interp_fwd": 1,
                     "softmax_interp_bwd": 1, "knn_topk": 0}
TRAJ_SUPERVISED_STEP = {**TRAJ_VAL, "corr_window_lookup_bwd": 48,
                        **bn_launches(RAFT_NORMS, True)}


def plain_pyramid_lookup(torch, pyramid, coords):
    """lookup_corr_pyramid through the plain window lookup, differentiable
    by torch autograd (gather, floor and the bilinear combine)."""
    from motionpriorcmax_tpu_torch.ops.cuda import corr_window as cw

    t0, b, _, h1, w1 = coords.shape
    outs = []
    for lvl, (idx, corr_l) in enumerate(pyramid):
        sel = torch.stack([coords[i] for i in idx]) / (2.0 ** lvl)
        h2, w2 = corr_l.shape[-2:]
        feat = cw.window_lookup_plain(corr_l.reshape(-1, h2, w2),
                                      sel[:, :, 0].reshape(-1),
                                      sel[:, :, 1].reshape(-1), RADIUS)
        outs.append(feat.reshape(len(idx), b, h1 * w1, K).permute(1, 0, 3, 2)
                    .reshape(b, len(idx) * K, h1, w1))
    return torch.cat(outs, dim=1)


def phase_bwd_kernel(torch):
    """Phase 19: corr_window_lookup_bwd against its plain version at the
    four level shapes of the B=6 training path, f32 and bf16 volumes; then
    the whole lookup, kernels forward and backward, against torch autograd
    of the plain lookup.  Returns (max error f32, max error bf16 d corr)."""
    from motionpriorcmax_tpu_torch.models.raft_spline.corr import (
        build_corr_pyramid, lookup_corr_pyramid)
    from motionpriorcmax_tpu_torch.ops.cuda import corr_window as cw

    b, tag = TRAIN_BATCH, "bwd-kernel-vs-plain"
    gen = torch.Generator(device="cuda").manual_seed(310)
    c_total = sum(t for t, _, _ in LEVELS) * K
    g = torch.randn(b, c_total, H // 8, W // 8, device="cuda", generator=gen)
    err32 = err16 = 0.0
    chan_off = 0
    for lvl, (t, h2, w2) in enumerate(LEVELS):
        for dtype in (torch.float32, torch.bfloat16):
            corr, cx, cy = level_inputs(torch, t, h2, w2, lvl, 300 + lvl,
                                        dtype, b)
            got = cw.corr_window_lookup_bwd(corr, cx, cy, RADIUS, g, chan_off)
            want = cw.corr_window_lookup_bwd_plain(corr, cx, cy, RADIUS, g,
                                                   chan_off)
            torch.cuda.synchronize()
            name = f"level {lvl + 1} N={t * b * Q} map {h2}x{w2} {str(dtype)[6:]}"
            bf16 = dtype == torch.bfloat16
            e = check_close(f"{name} d corr", got[0].float(),
                            want[0].float(), TOL_BWD_BF16 if bf16 else TOL_BWD,
                            tag)
            if bf16:
                err16 = max(err16, e)
            else:
                err32 = max(err32, e)
            for label, a, w in (("d cx", got[1], want[1]),
                                ("d cy", got[2], want[2])):
                err32 = max(err32, check_close(f"{name} {label}", a, w,
                                               TOL_BWD, tag))
            del corr, cx, cy, got, want
        chan_off += t * K
    del g
    torch.cuda.empty_cache()

    # The lookup over a B=6 Tab2L5 pyramid: CorrPyramidLookup (kernels both
    # ways) against autograd of the plain lookup, same cotangent.
    corr = torch.randn(5, b, Q, H // 8, W // 8, device="cuda", generator=gen)
    grid_y, grid_x = torch.meshgrid(torch.arange(H // 8, device="cuda"),
                                    torch.arange(W // 8, device="cuda"),
                                    indexing="ij")
    coords = (torch.stack([grid_x, grid_y]).float()[None, None]
              + 4 * torch.randn(5, b, 2, H // 8, W // 8, device="cuda",
                                generator=gen))
    g = torch.randn(b, c_total, H // 8, W // 8, device="cuda", generator=gen)
    results, times = {}, {}
    for kind, fn in (("kernels", lookup_corr_pyramid),
                     ("plain autograd",
                      lambda p, c, r: plain_pyramid_lookup(torch, p, c))):
        leaf = corr.clone().requires_grad_()
        crd = coords.clone().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(build_corr_pyramid(leaf, (1, 1, 1, 1, 4)), crd, RADIUS)
        out.backward(g)
        torch.cuda.synchronize()
        times[kind] = (time.perf_counter() - t0) * 1e3
        results[kind] = (out.detach(), leaf.grad, crd.grad)
        del leaf, crd, out
    for i, label in enumerate(("features", "d volume", "d coords")):
        err32 = max(err32, check_close(
            f"lookup B={b} Tab2L5 pyramid, kernels vs plain autograd: "
            f"{label}", results["kernels"][i], results["plain autograd"][i],
            TOL_BWD, tag))
    print(f"[{tag}] lookup forward + backward (one iteration, 4 levels, "
          f"first call): kernels {times['kernels']:.1f} ms, plain autograd "
          f"{times['plain autograd']:.1f} ms")
    del corr, coords, g, results
    torch.cuda.empty_cache()
    return err32, err16


def bwd_bound(torch, corr, cx, cy):
    """(bytes, ms) the lookup's backward must take on one level: the
    in-range window values, the cotangent slab and the coordinates read
    once; d corr (the whole maps, in the volume's dtype), d cx and d cy
    written; 4 weighted taps and 2 differences per window element."""
    n = corr.numel() // (corr.shape[-2] * corr.shape[-1])
    nbytes = (needed_bytes(torch, corr, cx, cy)
              + corr.numel() * corr.element_size() + n * 8)
    flops = n * K * 18
    return nbytes, max(nbytes / H100_BYTES_PER_S,
                       flops / H100_F32_FLOPS) * 1e3


def phase_bwd_timing(torch):
    """Phase 20: per level and per refinement iteration (4 launches), CUDA
    events, L2 flushed: the backward kernel, its bytes bound, its plain
    version, and F.grid_sample's backward (d input and d grid) for the same
    sampling (align_corners=True, zero padding)."""
    from torch.nn import functional as F

    from motionpriorcmax_tpu_torch.ops.cuda import corr_window as cw

    b = TRAIN_BATCH
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(320)
    c_total = sum(t for t, _, _ in LEVELS) * K
    g = torch.randn(b, c_total, H // 8, W // 8, device="cuda", generator=gen)
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                  fwd_bound_ms=0.0)
    levels, _ = level_set(torch, LEVELS, 400, torch.float32, b)
    slab = torch.empty(b, c_total, H // 8, W // 8, device="cuda")
    totals["fwd_ms"], totals["fwd_card_ms"], _ = timers(
        torch, lambda: cw.corr_window_lookup_levels(levels, RADIUS, slab),
        flush)
    del slab
    for lvl, (t, h2, w2) in enumerate(LEVELS):
        corr, cx, cy, off = levels[lvl]
        n = corr.shape[0] * b * Q
        f_bound = needed_bytes(torch, corr, cx, cy) / H100_BYTES_PER_S * 1e3
        k_ms = timers(torch, lambda: cw.corr_window_lookup_bwd(
            corr, cx, cy, RADIUS, g, off), flush)[0]
        p_ms = timers(torch, lambda: cw.corr_window_lookup_bwd_plain(
            corr, cx, cy, RADIUS, g, off), flush, reps=3, warmup=1)[0]
        d = torch.arange(-RADIUS, RADIUS + 1, device="cuda",
                         dtype=torch.float32)
        side = 2 * RADIUS + 1
        gx = (cx.reshape(n, 1, 1) + d[None, None, :]).expand(n, side, side)
        gy = (cy.reshape(n, 1, 1) + d[None, :, None]).expand(n, side, side)
        grid = torch.stack([2 * gx / (w2 - 1) - 1, 2 * gy / (h2 - 1) - 1],
                           dim=-1).contiguous().requires_grad_()
        img = corr.reshape(n, 1, h2, w2).detach().requires_grad_()
        out = F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                            align_corners=True)
        gout = torch.randn_like(out)
        l_ms = timers(torch, lambda: torch.autograd.grad(
            out, (img, grid), gout, retain_graph=True), flush, reps=5,
            warmup=1)[0]
        nbytes, bound = bwd_bound(torch, corr, cx, cy)
        print(f"[bwd-timing] level {lvl + 1} N={n} map {h2}x{w2} f32: "
              f"kernel={k_ms * 1e3:.1f} us bound={bound * 1e3:.1f} us "
              f"({nbytes / 1e6:.1f} MB, bytes-bound) plain={p_ms * 1e3:.1f} us"
              f" grid_sample backward={l_ms * 1e3:.1f} us; forward bound "
              f"{f_bound * 1e3:.1f} us")
        for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", bound),
                       ("library_ms", l_ms), ("fwd_bound_ms", f_bound)):
            totals[key] += v
        del corr, cx, cy, grid, img, out, gout, gx, gy
        torch.cuda.empty_cache()
    del flush, g, levels
    torch.cuda.empty_cache()
    print(f"[bwd-timing] one refinement iteration's backward (4 launches), "
          f"B={b}: kernel={totals['ms'] * 1e3:.1f} us "
          f"bound={totals['bound_ms'] * 1e3:.1f} us "
          f"plain={totals['plain_ms'] * 1e3:.1f} us grid_sample backward="
          f"{totals['library_ms'] * 1e3:.1f} us; the forward kernel at these "
          f"shapes (1 launch) {totals['fwd_ms'] * 1e3:.1f} us (card "
          f"{totals['fwd_card_ms'] * 1e3:.1f} us; bound "
          f"{totals['fwd_bound_ms'] * 1e3:.1f} us)")
    return totals


def traj_samples(seed, n, h, w, nbins_total, events=0, gt_steps=6,
                 flow_valid=True):
    """EVIMO2-shaped samples from a numpy seed: a sparse normalized voxel
    grid; with `events`, that many raw events (uniform positions in the
    loss image, sorted times, random polarity, the 41-bin index of the
    EVIMO2 reader) split into polarity halves; GT flow at `gt_steps`
    timestamps and, with `flow_valid`, a validity mask."""
    rng = np.random.default_rng(seed)
    edges = np.linspace(0, 1, TAB2L5_CONFIG["model"]["num_bins"]["context"]
                        + 1)
    samples = []
    for _ in range(n):
        ev_repr = rng.standard_normal((nbins_total, h, w), dtype=np.float32)
        ev_repr *= rng.random((nbins_total, h, w), dtype=np.float32) < 0.3
        s = {"ev_repr": ev_repr,
             "flow": 5 * rng.standard_normal((gt_steps, 2, h, w),
                                             dtype=np.float32),
             "flow_timestamps": np.linspace(0, 1, gt_steps + 1)[1:].astype(
                 np.float32)}
        if flow_valid:
            s["flow_valid"] = rng.random((gt_steps, h, w)) > 0.2
        if events:
            t = np.sort(rng.random(events))
            ev = np.stack([rng.random(events) * (h - 1),
                           rng.random(events) * (w - 1), t,
                           rng.integers(0, 2, events),
                           np.clip(np.searchsorted(edges, t) - 1, 0, None)],
                          -1).astype(np.float32)
            s["pos_events"] = ev[ev[:, 3] == 1]
            s["neg_events"] = ev[ev[:, 3] == 0]
        samples.append(s)
    return samples


def phase_traj_batches():
    """The traj-train host batches: B=6 self-supervised (2^19 events per
    sample, polarity-packed into capacity 2^20, LUT-cell-sorted) and
    supervised (5 GT steps), and 4 validation samples."""
    from motionpriorcmax_tpu_torch.data.collate import collate_fixed_capacity
    from motionpriorcmax_tpu_torch.models.raft_spline import RAFTSplineConfig

    nbt = RAFTSplineConfig().nbins_total
    loss = TAB2L5_CONFIG["loss"]
    t0 = time.perf_counter()
    selfsup = collate_fixed_capacity(
        traj_samples(51, TRAIN_BATCH, H, W, nbt, events=TRAIN_EVENTS),
        TRAIN_CAPACITY, polarity_aware=True,
        lut_cell_sort_params=((H, W), loss["num_bins"],
                              loss["lut_superpixel_size"]))
    t_collate = time.perf_counter() - t0
    supervised = collate_fixed_capacity(
        traj_samples(52, TRAIN_BATCH, H, W, nbt,
                     gt_steps=GT_STEPS_SUPERVISED, flow_valid=False),
        TRAIN_CAPACITY)
    val = traj_samples(53, 4, H, W, nbt)
    valid = int(selfsup["events"][..., 5].sum())
    print(f"[traj-batch] B={TRAIN_BATCH} {H}x{W}, {nbt} bins: "
          f"{TRAIN_EVENTS} events per sample in capacity {TRAIN_CAPACITY} "
          f"({valid} valid), events + collate {t_collate:.2f} s (one "
          f"thread); supervised batch with {GT_STEPS_SUPERVISED} GT steps; 4 "
          f"validation samples")
    return selfsup, supervised, val


def phase_traj_train(torch, cfg_tree, train_batch, val_samples, smi_line,
                     want, tag, supervised=False, want_losses=None):
    """traj-train's loop (training/loop.py::train_traj, the CLI's) at full
    width with seeded weights: 1 warm-up + 2 timed steps, 1 step under
    torch.profiler (the idle share), then the validation pass and a
    checkpoint.  Fails unless every step launches `want` and the val pass
    TRAJ_VAL, the loss is finite and moves, the context encoder's BatchNorm
    statistics move, TF32 is off in the forward and the backward, the
    validation metrics are finite and the checkpoint is written, and the
    first steps' losses are within TOL_STEP_LOSS of `want_losses` when
    given.  Returns the kernels' launch counts over the run."""
    import tempfile

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from motionpriorcmax_tpu_torch.cli.main import (run_traj_validation,
                                                    traj_train_configs)
    from motionpriorcmax_tpu_torch.training.loop import train_traj
    from motionpriorcmax_tpu_torch.training.raft_spline import \
        create_raft_train_state
    from motionpriorcmax_tpu_torch.utils import profiling

    cfg, tc, loss_cfg = traj_train_configs(cfg_tree, (H, W),
                                              TRAJ_SCHEDULE_STEPS)
    state = create_raft_train_state(cfg, tc, "cuda",
                                    torch.Generator().manual_seed(0))
    model = state.model
    bn_before = {n: b.clone() for n, b in model.cnet.named_buffers()
                 if "running" in n}
    seen_fwd, seen_bwd = set(), set()
    hooks = [getattr(model, name).register_forward_pre_hook(
        lambda mod, inp: seen_fwd.add(tf32_flags(torch)))
        for name in ("fnet_ev", "cnet", "update_block")]
    # Gradient hooks run inside the backward (the autograd engine's thread).
    for p in (model.fnet_ev.conv1.weight, model.cnet.conv1.weight,
              model.update_block.encoder.convc1.weight):
        hooks.append(p.register_hook(
            lambda grad: seen_bwd.add(tf32_flags(torch))))
    marks = []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def mark():
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), launch_counts()))

    def batches():
        for i in range(TRAIN_STEPS):
            mark()
            if i == TRAIN_STEPS - 1:
                prof.__enter__()
            yield train_batch

    ts = tuple(float(t) for t in val_samples[0]["flow_timestamps"])
    val_iters = cfg_tree["model"]["num_iter"]["test"]

    def validate(model):
        mark()                          # the end of the last step
        prof.__exit__(None, None, None)
        return run_traj_validation(model, val_samples, len(val_samples), ts,
                                   iters=val_iters)

    with tempfile.TemporaryDirectory() as workdir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        profiling.reset()
        train_traj(state, batches(), workdir, max_steps=TRAIN_STEPS,
                   loss_cfg=None if supervised else loss_cfg,
                   num_pos_events=train_batch.get("num_pos_events", -1),
                   log_every=1, val_every=TRAIN_STEPS, validate=validate)
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        with open(f"{workdir}/scalars.jsonl") as fh:
            recs = [json.loads(line) for line in fh]
        ckpts = sorted(p for p in os.listdir(f"{workdir}/checkpoints")
                       if p.endswith(".pt"))
    for h in hooks:
        h.remove()
    steps = [(t1 - t0, {k: c1[k] - c0[k] for k in c0})
             for (t0, c0), (t1, c1) in zip(marks[:-1], marks[1:])]
    losses = [r["train_losses/total"] for r in recs
              if "train_losses/total" in r]
    val = next(r for r in recs if "val/epe" in r)
    for i, (dt, counts) in enumerate(steps):
        note = (" (warm-up)" if i == 0 else " (torch.profiler)"
                if i == TRAIN_STEPS - 1 else "")
        print(f"[{tag}] step {i}{note}: {dt * 1e3:.1f} ms (host batch to "
              f"logged loss), loss {losses[i]:.6f}, launches "
              f"{launched(counts)}")
    if any(launched(counts) != launched(want) for _, counts in steps):
        fail(f"expected {launched(want)} launches per step, got "
             f"{[launched(c) for _, c in steps]}")
    in_val = {k: launches[k] - sum(c[k] for _, c in steps) for k in launches}
    if launched(in_val) != launched(TRAJ_VAL):
        fail(f"expected {launched(TRAJ_VAL)} launches in the val pass, got "
             f"{launched(in_val)}")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        fail(f"train losses {losses}")
    if len(set(losses)) < 2:
        fail(f"the loss did not move: {losses}")
    if want_losses is not None:
        if len(losses) < len(want_losses):
            fail(f"{len(losses)} step losses, fewer than the "
                 f"{len(want_losses)} recorded ones to hold them against")
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
        print(f"[{tag}] steps 0-{len(want_losses) - 1} losses against the "
              f"recorded ones {list(want_losses)}: max rel diff {rel:.2e} "
              f"(bound {TOL_STEP_LOSS:g})")
        if not rel <= TOL_STEP_LOSS:
            fail(f"the step losses {losses} moved from {want_losses}")
    bad = [k for k, v in val.items() if k != "step" and not np.isfinite(v)]
    if bad:
        fail(f"non-finite validation metrics {bad[:5]}")
    if not ckpts:
        fail("no checkpoint written")
    moved = sum(not torch.equal(b, bn_before[n])
                for n, b in model.cnet.named_buffers() if n in bn_before)
    if not moved:
        fail("the context encoder's BatchNorm statistics did not move")
    if seen_fwd != {(False, False)} or seen_bwd != {(False, False)}:
        fail(f"TF32 flags (matmul, cudnn): forward {seen_fwd}, backward "
             f"{seen_bwd}")
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    prof_wall = steps[-1][0] * 1e3
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    idle = (f"{1 - busy / prof_wall:.3f} ({busy:.1f} ms busy of "
            f"{prof_wall:.1f} ms)" if kernels else "not measured (no device "
            "time in the trace)")
    timed = [dt for dt, _ in steps[1:-1]]
    mean = float(np.mean(timed))
    b = train_batch["ev_repr"].shape[0]
    if supervised:
        rate = f"{b / mean:.3f} samples/s"
        what = (f"supervised, gamma 0.8, {train_batch['flow'].shape[1]} GT "
                "steps")
    else:
        m = train_batch["events"].shape[1]
        valid = float(train_batch["events"][..., 5].sum())
        rate = (f"{b * m / mean:.4g} events/s padded ({valid / mean:.4g} "
                "valid)")
        what = f"knn_method {loss_cfg.knn_method}, capacity {m}"
    print(f"[{tag}] Tab2L5 B={b} {H}x{W} compute {cfg.compute_dtype}, corr "
          f"{cfg.corr_dtype}, {cfg.iters} iterations, {what}: "
          f"step mean {mean * 1e3:.1f} ms over {len(timed)} steps "
          f"({', '.join(f'{x * 1e3:.1f}' for x in timed)}), {rate}, peak "
          f"memory {peak / 2**30:.2f} GiB, idle share {idle}; context BN "
          f"buffers moved {moved}/{len(bn_before)}; TF32 (matmul, cudnn) "
          f"forward {sorted(seen_fwd)} backward {sorted(seen_bwd)}; val pass "
          f"({len(val_samples)} samples, {val_iters} iterations) "
          f"val/masked_TEPE {val['val/masked_TEPE']:.4f} (launches "
          f"{launched(in_val)}); checkpoints {ckpts};"
          f" card {smi_line}")
    return launches


def tiny_traj_batches(cfg, h, w):
    """The self-supervised (B=2, 1500 events per sample in capacity 2048,
    cell-sorted) and supervised (3 GT steps) host batches of the test
    geometry."""
    from motionpriorcmax_tpu_torch.data.collate import collate_fixed_capacity

    rng = np.random.default_rng(61)
    samples = []
    for _ in range(2):
        t = np.sort(rng.random(1500))
        ev = np.stack([rng.random(1500) * (h - 1), rng.random(1500) * (w - 1),
                       t, rng.integers(0, 2, 1500),
                       np.clip((t * 5).astype(np.int64), 0, 4)], -1
                      ).astype(np.float32)
        samples.append({"pos_events": ev[ev[:, 3] == 1],
                        "neg_events": ev[ev[:, 3] == 0],
                        "ev_repr": rng.standard_normal(
                            (cfg.nbins_total, h, w), dtype=np.float32)})
    selfsup = collate_fixed_capacity(samples, 2048, True,
                                     lut_cell_sort_params=((h, w), 5, 4))
    supervised = {"ev_repr": selfsup["ev_repr"],
                  "flow": 2 * rng.standard_normal((2, 3, 2, h, w),
                                                  dtype=np.float32),
                  "flow_timestamps": np.tile(np.float32([1 / 3, 2 / 3, 1]),
                                             (2, 1)),
                  "flow_valid": rng.random((2, 3, h, w)) > 0.2}
    return selfsup, supervised


def phase_traj_card_vs_cpu(torch):
    """Phase 24: one f32 raft_train_step and one supervised step at the
    test geometry, on the CPU (plain versions) and on the card (kernels),
    same weights, batch and t_ref: loss, gradients, BN statistics."""
    from motionpriorcmax_tpu_torch.losses import FocusLossConfig
    from motionpriorcmax_tpu_torch.models.raft_spline import RAFTSplineConfig
    from motionpriorcmax_tpu_torch.training import raft_spline as trs
    from motionpriorcmax_tpu_torch.training.loop import to_device

    h = w = 32
    cfg = RAFTSplineConfig(nbins_context=5, nbins_correlation=3,
                           bezier_degree=2, ev_target_indices=(2, 4),
                           ev_levels=(1, 2), iters=2)
    loss_cfg = FocusLossConfig(image_shape=(h, w), num_bins=5, num_knn=4,
                               smooth_weight=0.01, lut_superpixel_size=4,
                               smooth_type="on_flow_to_next")
    selfsup, supervised = tiny_traj_batches(cfg, h, w)
    times = torch.tensor([0.37, 0.1, 0.3, 0.5, 0.7, 0.9])
    levels = max(cfg.ev_levels) * cfg.iters
    for kind, host, want in (
            ("raft_train_step", selfsup,
             {"corr_window_lookup": cfg.iters,
              "corr_window_lookup_bwd": levels, "iwe_vote_fwd": 2,
              "iwe_vote_bwd": 2, "lut_gather_fwd": 1, "lut_segsum_bwd": 1,
              "knn_topk": 1, **bn_launches(RAFT_NORMS, True)}),
            ("raft_supervised_train_step", supervised,
             {"corr_window_lookup": cfg.iters,
              "corr_window_lookup_bwd": levels,
              **bn_launches(RAFT_NORMS, True)})):
        results = {}
        before = launch_counts()
        for dev in ("cpu", "cuda"):
            state = trs.create_raft_train_state(
                cfg, trs.RAFTTrainConfig(), dev,
                torch.Generator().manual_seed(1))
            batch = to_device(host, torch.device(dev))
            if kind == "raft_train_step":
                logs = trs.raft_train_step(state, batch, None, loss_cfg,
                                           host["num_pos_events"],
                                           times=times)
            else:
                logs = trs.raft_supervised_train_step(state, batch)
            results[dev] = (float(logs["train_losses/total"]),
                            {n: p.grad.detach().cpu() for n, p in
                             state.model.named_parameters()},
                            {n: b.detach().cpu() for n, b in
                             state.model.named_buffers() if "running" in n})
        launches = launched({k: n - before[k]
                             for k, n in launch_counts().items()})
        (l_c, g_c, s_c), (l_g, g_g, s_g) = results["cpu"], results["cuda"]
        top = max(float(g.abs().max()) for g in g_c.values())
        loss_rel = abs(l_g - l_c) / abs(l_c)
        # A gradient that a norm cancels is zero up to rounding: it is held
        # to 1e-2 of the model's largest gradient, not to its own.
        grad_rel = max(float((g_g[n] - g_c[n]).abs().max()
                             / max(float(g_c[n].abs().max()), 1e-2 * top))
                       for n in g_c)
        bn_rel = max(float((s_g[n] - s_c[n]).abs().max()
                           / s_c[n].abs().max().clamp(min=1e-30))
                     for n in s_c)
        print(f"[traj-card-vs-cpu] f32 {kind} {h}x{w} B=2, {cfg.iters} "
              f"iterations: loss rel diff {loss_rel:.3e} (bound "
              f"{TOL_TRAIN_LOSS:g}), gradients max |diff| / max |grad| per "
              f"tensor {grad_rel:.3e} (bound {TOL_TRAIN_GRAD:g}), BN "
              f"statistics {bn_rel:.3e} (bound {TOL_TRAIN_BN:g}); card "
              f"launches {launches}")
        if not (loss_rel <= TOL_TRAIN_LOSS and grad_rel <= TOL_TRAIN_GRAD
                and bn_rel <= TOL_TRAIN_BN):
            fail(f"card and CPU {kind} disagree")
        if launches != launched(want):
            fail(f"the card's {kind} launched {launches}, not {want}")


# ---------------------------------------------------------------------------
# flow-train on unsorted events: the any-order segment sum (kernel row 5),
# the learning checks, the host data path
# ---------------------------------------------------------------------------

# The JAX package's learning checks, at their geometry
# (tests/test_focus_loss.py, test_flow_recovery.py,
# test_unet_selfsup_learning.py).
LEARN_H, LEARN_W, LEARN_BINS = 32, 48, 5
HOST_BATCHES = 3                   # loader batches timed per data case


def segment_sum_bound_ms(g, rr, xx):
    """Row 5's bytes bound: each event's C cotangents, the indices of the
    events with a nonzero one, and the grid written once."""
    live = int((g != 0).any(-1).sum())
    nbytes = g.numel() * 4 + live * 8 + g.shape[0] * rr * xx * g.shape[2] * 4
    return nbytes / H100_BYTES_PER_S * 1e3, nbytes


def phase_segment_sum(torch, loss_cfg, unsorted_batch):
    """Row 5 against its plain version at the unsorted flow-train shapes
    (B=14, M=2^20, LUT [1800, 160], C=2), on a skewed batch in time order,
    at the traj-train shapes (B=6, 2^19 events per sample in capacity
    2^20, LUT [3936, 128]) and with every cotangent on 8 cells; then timed
    against its bytes bound (ms and the card's time alone), the plain
    version, torch.gather's own backward (scatter_add_), and with the
    padding rows' cotangent nonzero or no padding at all.  Returns the
    numbers for the JSON line."""
    from motionpriorcmax_tpu_torch.ops.cuda import segment_sum as ss

    cases = segment_sum_cases(torch, unsorted_batch, loss_cfg)
    rows, cols, gev, r, x = cases["path"]
    b, m, _ = gev.shape
    valid = (gev != 0).any(-1).float()
    pad = 1.0 - float(torch.from_numpy(
        unsorted_batch["events"][..., 5]).mean())

    def check(label, rws, cls, g, rr, xx, tol):
        """(max |diff|, max |diff| / max |plain|); fails above tol."""
        got = ss.grid_segment_sum(rws, cls, g, rr, xx)
        want = ss.segment_sum_plain(rws, cls, g, rr, xx)
        if not bool(got.isfinite().all()):
            fail("grid_segment_sum left non-finite values")
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        print(f"[segsum-vs-plain] {label}: max |diff| {err:.3e}, / max "
              f"|plain| {rel:.3e} (bound {tol:g})")
        if not rel <= tol:
            fail(f"grid_segment_sum disagrees with plain: {label}")
        return err, rel

    errs = {"path": check(f"flow-train B={b} M={m} LUT [{r}, {x}] C=2, "
                          f"{pad:.3f} padding", rows, cols, gev, r, x,
                          TOL_SEGMENT_SUM),
            "skewed": check("skewed (half the live events in one 16 x 64 "
                            "region, 1% on one pixel), time order",
                            *cases["skewed"], TOL_SEGMENT_SUM)}
    gen = torch.Generator(device="cuda").manual_seed(32)
    few_r = torch.randint(0, 2, rows.shape, device="cuda", generator=gen,
                          dtype=torch.int32)
    few_c = torch.randint(0, 4, rows.shape, device="cuda", generator=gen,
                          dtype=torch.int32)
    few_g = torch.randn(b, m, 2, device="cuda", generator=gen)
    err_few = check("every cotangent on 8 cells per sample", few_r, few_c,
                    few_g, r, x, TOL_SEGMENT_SUM_FEW)
    del few_r, few_c, few_g
    t_rows, t_cols, t_g, tr, tx = cases["traj"]
    errs["traj"] = check(f"traj-train B={t_g.shape[0]} M={TRAIN_CAPACITY} "
                         f"({TRAIN_EVENTS} valid) LUT [{tr}, {tx}] C=2",
                         *cases["traj"], TOL_SEGMENT_SUM)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def gather_bwd(rws, cls, g, rr, xx):
        """torch.gather's backward: scatter_add_ into a zeroed grid."""
        flat = (rws.long() * xx + cls.long())[..., None].expand(-1, -1, 2)
        flat = flat.contiguous()
        out = torch.zeros(g.shape[0], rr * xx, 2, device="cuda")
        return lambda: out.zero_().scatter_add_(1, flat, g)

    def timed(label, rws, cls, g, rr, xx, plain=True):
        def kernel():
            return ss.grid_segment_sum(rws, cls, g, rr, xx)

        k_ms, card_ms, _ = timers(torch, kernel, flush)
        bnd, nbytes = segment_sum_bound_ms(g, rr, xx)
        nums = {"ms": k_ms, "card_ms": card_ms, "bound_ms": bnd}
        line = (f"[segsum-timing] {label}: kernel={k_ms * 1e3:.1f} us "
                f"(card {card_ms * 1e3:.1f} us) bound={bnd * 1e3:.1f} us "
                f"({nbytes / 1e6:.1f} MB, bytes)")
        if plain:
            nums["plain_ms"] = timers(
                torch, lambda: ss.segment_sum_plain(rws, cls, g, rr, xx),
                flush, reps=5, warmup=1)[0]
            nums["library_ms"] = timers(torch, gather_bwd(rws, cls, g, rr,
                                                          xx),
                                        flush, reps=5, warmup=1)[0]
            line += (f" plain={nums['plain_ms'] * 1e3:.1f} us library "
                     f"(torch.gather's backward, scatter_add_)="
                     f"{nums['library_ms'] * 1e3:.1f} us")
        print(line)
        return nums

    out = timed("flow-train, the path's batch", rows, cols, gev, r, x)
    out["bound_by"] = "bytes"
    out["max_abs_err"], out["max_rel_err"] = errs["path"]
    out["few_cells_max_abs_err"], out["few_cells_max_rel_err"] = err_few
    for label in ("skewed", "traj"):
        nums = timed(f"{label} shapes" if label == "traj" else
                     "skewed batch, time order", *cases[label],
                     plain=label == "traj")
        out.update({f"{label}_{k}": v for k, v in nums.items()})
        out[f"{label}_max_abs_err"], out[f"{label}_max_rel_err"] = \
            errs[label]
    # The same batch with the padding rows' cotangent nonzero (what the
    # zero skip saves: ~48k same-address atomics per sample), and with no
    # padding at all (the padding rows drawn as valid events).
    g_padnz = torch.where(valid[..., None] > 0, gev, torch.randn_like(gev))
    out["padding_cotangent_nonzero_ms"] = timers(
        torch, lambda: ss.grid_segment_sum(rows, cols, g_padnz, r, x),
        flush)[0]
    full_r = torch.where(valid > 0, rows, torch.randint_like(rows, 0, r))
    full_c = torch.where(valid > 0, cols, torch.randint_like(cols, 0, x))
    out["no_padding_ms"] = timers(
        torch, lambda: ss.grid_segment_sum(full_r, full_c, g_padnz, r, x),
        flush)[0]
    print(f"[segsum-timing] padding rows ({pad:.3f} of the events, all in "
          f"cell (0, 0)): skipped (the path) {out['ms'] * 1e3:.1f} us, "
          f"with a nonzero cotangent "
          f"{out['padding_cotangent_nonzero_ms'] * 1e3:.1f} us; no padding "
          f"(every row a valid event) {out['no_padding_ms'] * 1e3:.1f} us")
    del cases, rows, cols, gev, g_padnz, full_r, full_c, t_rows, t_cols, t_g
    del flush
    torch.cuda.empty_cache()
    return out


def phase_unsorted_train(torch, cfg, loss_cfg, train_batch, val_batch,
                         smi_line, sorted_ms):
    """train_flow on the unsorted batches (softmax, device voxel): 1
    warm-up + 2 timed steps and a val pass, launches per step as
    UNSORTED_STEP, TF32 off in the UNet's forward and backward; the sorted
    step of phase 16 beside it.  Returns the launch counts."""
    from motionpriorcmax_tpu_torch.training.trajectory_net import \
        create_train_state

    if "lut_cell_ends" in train_batch or "voxel" in train_batch:
        fail("the unsorted batch carries lut_cell_ends or a voxel grid")
    state = create_train_state(cfg, "cuda", torch.Generator().manual_seed(0))
    unet = state.model.unet
    seen_fwd, seen_bwd = set(), set()
    hooks = [unet.register_forward_pre_hook(
        lambda mod, inp: seen_fwd.add(tf32_flags(torch))),
        next(unet.parameters()).register_hook(
            lambda grad: seen_bwd.add(tf32_flags(torch)))]
    try:
        launches, mean_ms = phase_flow_train(
            torch, cfg, loss_cfg, train_batch, val_batch, smi_line,
            UNSORTED_STEP, UNSORTED_VAL, tag="unsorted-train", state=state,
            want_losses=SOFTMAX_STEP_LOSSES,
            n_steps=len(SOFTMAX_STEP_LOSSES))
    finally:
        for hk in hooks:
            hk.remove()
    print(f"[unsorted-train] TF32 (matmul, cudnn) inside the UNet forward "
          f"{sorted(seen_fwd)}, backward {sorted(seen_bwd)}; step "
          f"{mean_ms:.1f} ms unsorted against {sorted_ms:.1f} ms cell-sorted "
          f"(phase 16, this call)")
    if seen_fwd != {(False, False)} or seen_bwd != {(False, False)}:
        fail("TF32 was on inside the unsorted train step")
    return launches, mean_ms


def translating_events(rng, flow_yx, n_lines, m):
    """tests/test_focus_loss.py::make_translating_events: events of a few
    edges translating with a constant flow over t in [0, 1] -> [1, m, 6]."""
    fy, fx = flow_yx
    base_y = rng.uniform(4, LEARN_H - 12, n_lines)
    base_x = rng.uniform(4, LEARN_W - 12, n_lines)
    ts = rng.uniform(0, 1, m)
    which = rng.integers(0, n_lines, m)
    jitter = rng.uniform(-0.5, 0.5, (m, 2))
    y = base_y[which] + fy * ts + jitter[:, 0]
    x = base_x[which] + fx * ts + jitter[:, 1]
    p = rng.integers(0, 2, m).astype(np.float32)
    bins = np.clip((ts * LEARN_BINS).astype(np.int32), 0, LEARN_BINS - 1)
    ev = np.stack([y, x, ts, p, bins, np.ones(m)], axis=-1).astype(np.float32)
    return ev[None]


def learn_loss_cfg(**kw):
    """tests/test_focus_loss.py::make_cfg, the port's config."""
    from motionpriorcmax_tpu_torch.losses import FocusLossConfig

    defaults = dict(
        image_shape=(LEARN_H, LEARN_W), num_tref=1, num_bins=LEARN_BINS,
        num_knn=4, smooth_weight=0.0, lut_superpixel_size=4,
        focus_loss_norm="l1", dist_norm="l2", scale_iwe_by_dt=True,
        mask_image_border=True, polarity_aware_batching=False,
        interpolation_scheme="mean", smooth_type="on_flow_to_tref",
        knn_block_size=64)
    defaults.update(kw)
    return FocusLossConfig(**defaults)


def phase_learning(torch):
    """The JAX package's two learning checks, through the port on the card,
    on unsorted events (so each gradient runs row 5): loss-only recovery
    of a translation (tests/test_flow_recovery.py: 45 Adam(0.5) steps on
    per-trajectory constant-flow coefficients, exact and softmax; cos >
    0.95, magnitude ratio > 0.5) and the UNet self-supervised step
    (tests/test_unet_selfsup_learning.py: 120 train_steps with the voxel
    grid voted in the step; the mean dense flow within 2.5 px of (5, 7))."""
    from motionpriorcmax_tpu_torch.losses import (focus_loss,
                                                  get_reconstruction_times)
    from motionpriorcmax_tpu_torch.ops.cuda import segment_sum as ss
    from motionpriorcmax_tpu_torch.ops.grids import tile_mask_positions
    from motionpriorcmax_tpu_torch.training import trajectory_net as ttn

    for method in ("exact", "softmax"):
        t0 = time.perf_counter()
        true_flow = np.array([3.0, -4.0], np.float32)
        events = torch.from_numpy(translating_events(
            np.random.default_rng(0), tuple(true_flow), 8, 1024)).cuda()
        cfg = learn_loss_cfg(knn_method=method, num_knn=8, smooth_weight=0.02,
                             scale_iwe_by_dt=False)
        pos = torch.from_numpy(tile_mask_positions(
            (LEARN_H, LEARN_W), 4).astype(np.float32)).cuda()
        coeffs = torch.zeros(1, pos.shape[0], 2, device="cuda",
                             requires_grad=True)
        opt = torch.optim.Adam([coeffs], lr=0.5)
        gen = torch.Generator().manual_seed(0)
        before = ss.grid_segment_sum.launches
        for _ in range(45):
            times = get_reconstruction_times(cfg, gen, "cuda")
            traj = pos[None, None] + coeffs[:, None] * times[None, :, None,
                                                             None]
            loss = focus_loss(cfg, traj, times, events)[0]
            opt.zero_grad()
            loss.backward()
            opt.step()
        launches = ss.grid_segment_sum.launches - before
        c = coeffs.detach().cpu().numpy()[0]
        moved = c[np.linalg.norm(c, axis=-1) > 1.0]
        est = np.median(moved, axis=0) if len(moved) else np.zeros(2)
        cos = float(est @ true_flow / max(
            np.linalg.norm(est) * np.linalg.norm(true_flow), 1e-12))
        mag = float(np.linalg.norm(est) / np.linalg.norm(true_flow))
        print(f"[learning] loss-only recovery, {method}: {len(moved)} "
              f"trajectories moved, median flow {est.round(3).tolist()} vs "
              f"{true_flow.tolist()}: cos {cos:.4f} (> 0.95), magnitude "
              f"ratio {mag:.3f} (> 0.5); {launches} segment-sum launches in "
              f"45 steps; {time.perf_counter() - t0:.1f} s")
        if len(moved) <= 10 or not (cos > 0.95 and mag > 0.5):
            fail(f"loss-only recovery ({method}) did not recover the flow")
        if launches != 45:
            fail(f"expected 45 segment-sum launches, got {launches}")

    t0 = time.perf_counter()
    true_flow = (5.0, 7.0)
    ev = translating_events(np.random.default_rng(0), true_flow, 10, 2048)
    cfg = ttn.TrajectoryNetConfig(image_shape=(LEARN_H, LEARN_W),
                                  num_bins=LEARN_BINS, num_basis=1,
                                  patch_size=4, lr=1e-3)
    loss_cfg = learn_loss_cfg(num_knn=8, smooth_weight=0.003,
                              knn_method="exact")
    batch = {"events": torch.from_numpy(ev).cuda()}
    state = ttn.create_train_state(cfg, "cuda",
                                   torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    before = ss.grid_segment_sum.launches
    first, last = [], []
    for i in range(120):
        logs = ttn.train_step(state, batch, gen, cfg, loss_cfg)
        (first if i < 20 else last).append(
            float(logs["train_losses/focus_loss"]))
    launches = ss.grid_segment_sum.launches - before
    voxel = ttn.voxelize_batch_on_device(cfg, batch["events"])
    flow = ttn.predict_flow(state, voxel, cfg)[0].cpu().numpy()
    est = np.array([flow[0].mean(), flow[1].mean()])
    err = float(np.linalg.norm(est - np.asarray(true_flow)))
    print(f"[learning] UNet self-supervised, 120 steps ({cfg.compute_dtype}, "
          f"widths {list(cfg.unet_widths)}, exact KNN, unsorted events): "
          f"focus loss {np.mean(first):.5f} (steps 0-19) -> "
          f"{np.mean(last):.5f} (20-119), mean dense flow "
          f"{est.round(3).tolist()} vs {list(true_flow)}: error {err:.3f} px "
          f"(< 2.5); {launches} segment-sum launches; "
          f"{time.perf_counter() - t0:.1f} s")
    if not err < 2.5:
        fail("the UNet self-supervised step did not recover the flow")
    if launches != 120:
        fail(f"expected 120 segment-sum launches, got {launches}")


class SyntheticDsec:
    """In-memory DSEC-like sequence for the loader (the card's machine has
    no h5py): per window, 1M raw events (uint16 x, y in the sensor, sorted
    int64 microsecond times, uint8 polarity) and a rectify map with
    sub-pixel offsets; __getitem__ does what DsecSequence.__getitem__ does
    after its h5 read: the native pack, the host voxel grid unless
    `device_voxel`, and the polarity split."""

    def __init__(self, n_windows, n_events, h, w, nb, device_voxel):
        rng = np.random.default_rng(61)
        self.h, self.w, self.nb = h, w, nb
        self.device_voxel = device_voxel
        gx, gy = np.meshgrid(np.arange(w, dtype=np.float32),
                             np.arange(h, dtype=np.float32))
        self.rect = np.ascontiguousarray(np.stack(
            [gx, gy], -1) + rng.uniform(-0.5, 0.5, (h, w, 2)).astype(
                np.float32))
        self.windows = [
            {"x": rng.integers(0, w, n_events).astype(np.uint16),
             "y": rng.integers(0, h, n_events).astype(np.uint16),
             "t": np.sort(rng.integers(0, 100_000, n_events)).astype(np.int64),
             "p": rng.integers(0, 2, n_events).astype(np.uint8)}
            for _ in range(n_windows)]
        self.length = n_windows

    def __len__(self):
        return self.length

    def __getitem__(self, i):
        from motionpriorcmax_tpu_torch import native
        from motionpriorcmax_tpu_torch.data.host_ops import \
            voxelize_normalized_host

        ev = self.windows[i % len(self.windows)]
        events = native.pack_dsec_events(ev["x"], ev["y"], ev["t"], ev["p"],
                                         self.rect, self.h, self.w, self.nb)
        out = {"file_index": np.asarray(i, np.int64)}
        if not self.device_voxel:
            out["voxel"] = voxelize_normalized_host(events, self.nb, self.h,
                                                    self.w)
        out["pos_events"] = events[events[:, 3] == 1]
        out["neg_events"] = events[events[:, 3] == 0]
        return out


def phase_host_data(torch, cfg, loss_cfg, step_ms):
    """DataLoader batches/s at the flow-train shapes (B=14, capacity 2^20,
    1M events per window, 480x640, 15 bins; the CLI's 16 workers, pinned
    batches) for {cell-sorted, unsorted} x {host voxel, device voxel},
    against the step that consumes such batches; and one batch's collate
    before (NumPy twins, one producer thread) and after (native, the pool).
    Fails unless the native ops ran."""
    from motionpriorcmax_tpu_torch import native
    from motionpriorcmax_tpu_torch.data.collate import collate_fixed_capacity
    from motionpriorcmax_tpu_torch.data.loader import DataLoader

    h, w = cfg.image_shape
    nb = cfg.num_bins
    b = DSEC_CONFIG["data"]["batch_size"]
    workers = DSEC_CONFIG["data"]["num_workers"]
    sort = (loss_cfg.image_shape, loss_cfg.num_bins,
            loss_cfg.lut_superpixel_size)
    t0 = time.perf_counter()
    data = SyntheticDsec(b, FLOW_EVENTS, h, w, nb, device_voxel=True)
    print(f"[host-data] {b} windows of {FLOW_EVENTS} raw events made in "
          f"{time.perf_counter() - t0:.2f} s; {os.cpu_count()} host cores, "
          f"{workers} loader workers")
    native.calls.clear()
    results = {}
    for sorted_, device_voxel in ((True, False), (False, False),
                                  (True, True), (False, True)):
        data.device_voxel = device_voxel
        data.length = b * (HOST_BATCHES + 1)
        loader = DataLoader(data, batch_size=b, capacity=FLOW_CAPACITY,
                            shuffle=False, num_workers=workers,
                            polarity_aware=True,
                            lut_cell_sort_params=sort if sorted_ else None,
                            pin_memory=True)
        stamps = []
        t0 = time.perf_counter()
        for batch in loader:
            stamps.append(time.perf_counter())
            if ("lut_cell_ends" in batch) != sorted_ or (
                    "voxel" in batch) == device_voxel:
                fail("the loader's batch does not match its case")
            if not torch.from_numpy(batch["events"]).is_pinned():
                fail("the loader's batch is not in pinned memory")
            del batch
        first = stamps[0] - t0
        rate = HOST_BATCHES / (stamps[-1] - stamps[0])
        label = (f"{'cell-sorted' if sorted_ else 'unsorted'}, "
                 f"{'device' if device_voxel else 'host'} voxel")
        step, step_name = step_ms[(sorted_, device_voxel)]
        keeps = rate * step / 1e3 >= 1.0
        print(f"[host-data] {label}: first batch {first:.2f} s, then "
              f"{rate:.3f} batches/s ({1e3 / rate:.0f} ms per batch) against "
              f"the {step_name} step of {step:.1f} ms on the card: the loader "
              f"{'keeps up' if keeps else 'does NOT keep up'} "
              f"({rate * step / 1e3:.2f} batches per step)")
        results[label] = {"batches_per_s": rate, "step_ms": step,
                          "keeps_up": keeps}
    if not (native.calls["pack_dsec_events"] and
            native.calls["lut_cell_sort_segment"] and
            native.calls["voxelize_trilinear"]):
        fail(f"the native host ops did not run: {dict(native.calls)}")
    print(f"[host-data] native calls {dict(native.calls)}")

    # One batch's collate: the NumPy twins in one thread (the loader before
    # this change) against the native ops on the pool (after it).
    data.device_voxel = True
    samples = [data[i] for i in range(b)]
    t0 = time.perf_counter()
    with native.numpy_only():
        collate_fixed_capacity(samples, FLOW_CAPACITY, polarity_aware=True,
                               lut_cell_sort_params=sort)
    before = time.perf_counter() - t0

    class Ready:
        def __len__(self):
            return b

        def __getitem__(self, i):
            return samples[i]

    t0 = time.perf_counter()
    next(iter(DataLoader(Ready(), batch_size=b, capacity=FLOW_CAPACITY,
                         shuffle=False, num_workers=workers,
                         polarity_aware=True, lut_cell_sort_params=sort,
                         pin_memory=True)))
    after = time.perf_counter() - t0
    print(f"[host-data] one batch's collate (pad, polarity packing, LUT-cell "
          f"sort, stack) of {b} ready samples: {before:.2f} s with the NumPy "
          f"twins in one thread, {after:.2f} s native on the pool")
    results["collate_s"] = {"numpy_one_thread": before, "native_pool": after}
    return results


# ---------------------------------------------------------------------------
# dsec-infer: DSEC benchmark inference (config/dsec_inference.yaml)
# ---------------------------------------------------------------------------

INFER_WINDOWS = 9                  # 1 warm-up + 8 timed
INFER_RAW_EVENTS = (500_000, 3_000_000)   # raw events per 100 ms window
# The voxel vote at B=1: N = 0, 1, one past a 4096-event chunk, ~1M, ~3M.
INFER_VOTE_N = (0, 1, 4097, 1 << 20, 3_000_000)
# The 416 windows of the seven CSVs of config/misc/dsec_test_timestamps.
BENCHMARK_WINDOWS = 416
# The seeded UNet's output bias in the full-width phase, px of (y, x) flow:
# |flow| ~68 px before the 60 px cap, so the cap is exercised (the seeded
# weights alone give flows under 1 px); the field stays smooth, as a
# trained model's is, where scaled-up random weights would give noise
# that zlib compresses several times slower.
INFER_OUT_BIAS = 48.0
INFER_STEP = {**EXACT_STEP, "iwe_vote_fwd": 0, "iwe_vote_bwd": 0,
              "lut_gather_fwd": 0, "lut_segsum_bwd": 0, "voxel_vote": 1,
              "knn_topk": 0, **bn_launches(UNET_NORMS, False)}


def infer_vote_events(torch, n, seed, h=480, w=640, nb=15):
    """[1, n, 6] rows on the card as infer_window makes them from a packed
    window: fractional rectified (y, x), 2% of them on the last row (y in
    [479, 480)) and 2% on the last column, sorted t in [0, 1], random p,
    the bin of t, valid 1."""
    rng = np.random.default_rng(seed)
    y = rng.random(n) * h
    x = rng.random(n) * w
    last = rng.random(n)
    y = np.where(last < 0.02, h - 1 + rng.random(n), y)
    x = np.where(last > 0.98, w - 1 + rng.random(n), x)
    t = np.sort(rng.random(n))
    binned = np.clip(np.searchsorted(np.linspace(0, 1, nb + 1), t) - 1, 0,
                     None)
    ev = np.stack([y, x, t, rng.integers(0, 2, n), binned, np.ones(n)], -1)
    return torch.from_numpy(ev.astype(np.float32)[None]).cuda()


def phase_infer_vote(torch):
    """Row 8 against its plain version at the inference shapes (B = 1, N
    varying per window), then timed at ~1M and ~3M events: the card's
    time, the bytes bound (24 N + 4 x 15 x 480 x 640 at 3.35 TB/s), the
    plain version and index_add_ of the eight taps."""
    from motionpriorcmax_tpu_torch.ops.cuda import voxel_vote as vv

    c = DSEC_INFERENCE_CONFIG["common"]
    nb, h, w = c["num_bins"], c["height"], c["width"]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    cases = []
    for i, n in enumerate(INFER_VOTE_N):
        ev = infer_vote_events(torch, n, 40 + i, h, w, nb)
        got = vv.voxel_vote(ev, nb, h, w)
        want = vv.voxel_vote_plain(ev, nb, h, w)
        err = check_close(f"voxel_vote B=1 N={n} {nb}x{h}x{w} (fractional, "
                          f"4% on the last row / column)", got, want,
                          TOL_VOXEL, tag="infer-vote")
        if n == 0 and bool(got.any()):
            fail("voxel_vote of an empty window left nonzero values")
        if n > 1:
            # The last row and column hold votes: their floor + 1 taps are
            # masked, their floor taps are not.
            if not (bool(want[..., h - 1, :].any())
                    and bool(want[..., :, w - 1].any())):
                fail("no votes on the last row or column")
        case = {"n": n, "max_abs_err": err}
        if n >= 1 << 20:
            idx, val = vv.voxel_taps(ev, nb, h, w)
            idx, val = idx.reshape(-1), val.reshape(-1)
            img = torch.zeros(nb * h * w, device="cuda")
            nbytes = 24 * n + 4 * nb * h * w
            k_ms, card_ms, _ = timers(
                torch, lambda: vv.voxel_vote(ev, nb, h, w), flush)
            case.update(time_kernel(
                torch, f"voxel_vote inference B=1 N={n}", k_ms,
                lambda: vv.voxel_vote_plain(ev, nb, h, w),
                lambda: img.zero_().index_add_(0, idx, val), flush, nbytes))
            case["card_ms"] = card_ms
            print(f"[infer-vote] B=1 N={n}: card time "
                  f"{case['card_ms'] * 1e3:.1f} us, bound "
                  f"{case['bound_ms'] * 1e3:.1f} us "
                  f"({case['bound_ms'] / case['card_ms']:.0%} of it)")
            del idx, val, img
        cases.append(case)
        del ev, got, want
    del flush
    torch.cuda.empty_cache()
    return cases


def infer_sequence_arrays(seed, n_windows, name="zurich_city_99_z"):
    """An in-memory DSEC test sequence as DsecSequence reads it (the
    arrays of an events.h5, a rectify map, a timestamp CSV's rows): 100 ms
    windows 500 ms apart, each of raw events drawn from INFER_RAW_EVENTS
    (sensor x, y; sorted microsecond times; random polarity), the rectify
    map a radial distortion (sub-pixel coordinates, the corners mapped out
    of the image) with two bands mapped onto the last row and column."""
    rng = np.random.default_rng(seed)
    h, w = 480, 640
    counts = rng.integers(*INFER_RAW_EVENTS, n_windows)
    starts = 1_000_000 + 500_000 * np.arange(n_windows)
    t = np.concatenate([np.sort(rng.integers(s, s + 100_000, k))
                        for s, k in zip(starts, counts)]).astype(np.int64)
    total = len(t)
    duration_ms = int(starts[-1] // 1000) + 200
    arrays = {
        "events/t": t,
        "events/x": rng.integers(0, w, total).astype(np.uint16),
        "events/y": rng.integers(0, h, total).astype(np.uint16),
        "events/p": rng.integers(0, 2, total).astype(np.uint8),
        "ms_to_idx": np.searchsorted(
            t, np.arange(duration_ms + 1) * 1000).astype(np.int64),
        "t_offset": np.asarray(50_000_000_000, np.int64),
    }
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    r2 = (gx - w / 2) ** 2 + (gy - h / 2) ** 2
    scale = 1.0 + 2e-7 * r2
    rect = np.stack([w / 2 + (gx - w / 2) * scale,
                     h / 2 + (gy - h / 2) * scale], -1)
    rect[100:108, :, 1] = h - 1 + 0.6
    rect[:, 200:208, 0] = w - 1 + 0.7
    offset = int(arrays["t_offset"])
    rows = [(offset + s, offset + s + 100_000, 10 * (i + 1))
            for i, s in enumerate(starts)]
    return arrays, rect.astype(np.float32), rows, counts


def write_timestamp_csv(path, rows):
    """A benchmark CSV as config/misc/dsec_test_timestamps holds them (a
    space after each comma)."""
    with open(path, "w") as fh:
        fh.write("from_timestamp_us,to_timestamp_us,file_index\n")
        for a, b, c in rows:
            fh.write(f"{a}, {b}, {c}\n")


def infer_sequence_at(path, csv_path, arrays, rect):
    from pathlib import Path

    from motionpriorcmax_tpu_torch.data.dsec import DsecSequence

    nb = DSEC_INFERENCE_CONFIG["common"]["num_bins"]
    return DsecSequence(Path(path), "test", nb, timestamp_path=str(csv_path),
                        event_file=arrays, rectify_map=rect)


def infer_state(torch, device, unet_widths=None):
    """dsec_inference.yaml's model (f32) through the CLI's config, seeded
    weights; `unet_widths` narrows it."""
    from motionpriorcmax_tpu_torch.cli.main import infer_config
    from motionpriorcmax_tpu_torch.config import propagate_config
    from motionpriorcmax_tpu_torch.training import trajectory_net as ttn

    tree = propagate_config(copy.deepcopy(DSEC_INFERENCE_CONFIG))
    if unet_widths is not None:
        tree["model"]["unet_widths"] = list(unet_widths)
    cfg = infer_config(tree)
    return ttn.create_train_state(cfg, device,
                                  torch.Generator().manual_seed(0)), cfg


def check_pngs(out_dir, rows):
    """Every PNG of the windows read back: decoded, finite, within the
    60 px cap plus the quantization (each component rounded down to a
    1/128 px step: sqrt(2) / 128 px on the magnitude).  Returns the largest
    flow magnitude."""
    from motionpriorcmax_tpu_torch.cli.main import MAX_FLOW_PX
    from motionpriorcmax_tpu_torch.utils.flow_io import load_flow_png

    largest = 0.0
    for _, _, idx in rows:
        flow, _ = load_flow_png(out_dir / f"{idx:06d}.png")
        if flow.shape != (2, 480, 640) or not np.isfinite(flow).all():
            fail(f"{idx:06d}.png: shape {flow.shape} or non-finite flow")
        mag = float(np.sqrt((flow ** 2).sum(0)).max())
        if not mag <= MAX_FLOW_PX + np.sqrt(2) / 128:
            fail(f"{idx:06d}.png: flow magnitude {mag} above the cap")
        largest = max(largest, mag)
    return largest


def phase_infer(torch, smi_line):
    """dsec-infer end to end at full width: dsec_inference.yaml (f32 UNet
    64-1024, B=1, 480x640), seeded weights, the CLI's per-sequence function
    over an in-memory sequence of INFER_WINDOWS windows (its native pack
    through DsecSequence.__getitem__).  A first pass with 1 warm-up window
    and INFER_WINDOWS - 1 timed; a second with the card synchronized at
    every part (CUDA events for the card's parts, the host clock for the
    pack and the PNG; infer_part_marks).  Returns (voxel_vote launches in
    the first pass, numbers)."""
    import tempfile
    from pathlib import Path

    from motionpriorcmax_tpu_torch.cli.main import infer_sequence
    from motionpriorcmax_tpu_torch.utils import profiling

    norm = DSEC_INFERENCE_CONFIG["data"]["norm_type"]
    t0 = time.perf_counter()
    arrays, rect, rows, counts = infer_sequence_arrays(21, INFER_WINDOWS)
    print(f"[dsec-infer] in-memory sequence: {INFER_WINDOWS} windows of "
          f"{', '.join(str(int(c)) for c in counts)} raw events, made in "
          f"{time.perf_counter() - t0:.2f} s")
    state, cfg = infer_state(torch, "cuda")
    with torch.no_grad():
        state.model.unet.outc.conv.bias.fill_(INFER_OUT_BIAS)
    seen = set()
    hook = state.model.unet.register_forward_pre_hook(
        lambda mod, inp: seen.add(tf32_flags(torch)))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_timestamp_csv(tmp / "seq.csv", rows)
        seq = infer_sequence_at(tmp / "zurich_city_99_z", tmp / "seq.csv",
                                arrays, rect)
        stamps = []

        def stamp(part):
            if part == "png":
                stamps.append(time.perf_counter())

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        profiling.reset()
        t_run = time.perf_counter()
        with infer_part_marks(state, seq, stamp) as marked:
            n = infer_sequence(state, cfg, marked, tmp / "flow", norm,
                               torch.device("cuda"))
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        per_window = np.diff([t_run] + stamps)
        largest = check_pngs(tmp / "flow", rows)
        if not largest >= 60 - np.sqrt(2) / 128:
            fail(f"the largest flow in the PNGs, {largest} px, never reached "
                 "the 60 px cap")

        # Pass 2: the parts of each window.
        parts = {}
        ev_marks, host_marks = [], []

        def part_mark(part):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            torch.cuda.synchronize()
            ev_marks.append((part, ev))
            host_marks.append((part, time.perf_counter()))

        part_mark("start")
        with infer_part_marks(state, seq, part_mark) as marked:
            infer_sequence(state, cfg, marked, tmp / "flow2", norm,
                           torch.device("cuda"))
        check_pngs(tmp / "flow2", rows)
        per_part = len(INFER_PARTS) + 1
        if [p for p, _ in ev_marks[1:]] != n * list(INFER_PARTS):
            fail(f"the parts of the windows came as "
                 f"{[p for p, _ in ev_marks]}, not {list(INFER_PARTS)} "
                 f"{n} times")
        for wi in range(1, n):             # window 0 is the warm-up
            base = wi * (per_part - 1)
            for j in range(1, per_part):
                part, ev = ev_marks[base + j]
                _, prev_ev = ev_marks[base + j - 1]
                if part in ("pack", "png"):
                    ms = (host_marks[base + j][1]
                          - host_marks[base + j - 1][1]) * 1e3
                else:
                    ms = prev_ev.elapsed_time(ev)
                parts.setdefault(part, []).append(ms)
        packed = [len(seq[i]["events"]) for i in range(n)]
    hook.remove()
    timed = per_window[1:]
    mean_ms = float(np.mean(timed)) * 1e3
    if n != INFER_WINDOWS:
        fail(f"{n} windows inferred, not {INFER_WINDOWS}")
    per = {k: v / n for k, v in launches.items()}
    if launched(per) != launched(INFER_STEP):
        fail(f"expected {launched(INFER_STEP)} launches per window, got "
             f"{launched(launches)} over {n} windows")
    if seen != {(False, False)}:
        fail(f"the f32 UNet ran with TF32 flags (matmul, cudnn) {seen}")
    for i, dt in enumerate(per_window):
        print(f"[dsec-infer] window {i}{' (warm-up)' if i == 0 else ''}: "
              f"{counts[i]} raw -> {packed[i]} packed events, "
              f"{dt * 1e3:.1f} ms")
    mean_parts = {k: float(np.mean(v)) for k, v in parts.items()}
    total = sum(mean_parts.values())
    print(f"[dsec-infer] dsec_inference.yaml B=1 480x640 f32 UNet "
          f"{list(cfg.unet_widths)}: {mean_ms:.1f} ms per window over "
          f"{len(timed)} windows ({', '.join(f'{x * 1e3:.1f}' for x in timed)}"
          f"), {1e3 / mean_ms:.3f} windows/s, peak memory "
          f"{peak / 2**30:.2f} GiB, voxel_vote launches per window "
          f"{launches['voxel_vote'] / n:g}, TF32 (matmul, cudnn) inside the "
          f"forward: {sorted(seen)}; largest flow in the PNGs {largest:.3f} px "
          f"(cap 60; output bias {INFER_OUT_BIAS:g} px); card "
          f"{smi_line}")
    print("[dsec-infer] parts per window, synchronized pass (mean over "
          f"{len(timed)} windows; CUDA events, host clock for pack and png): "
          + ", ".join(f"{k} {v:.2f} ms ({v / total:.1%})"
                      for k, v in mean_parts.items())
          + f"; sum {total:.1f} ms")
    host = mean_parts["pack"] + mean_parts["png"]
    print(f"[dsec-infer] host share (pack + scale/PNG) {host / total:.1%}; "
          f"the {BENCHMARK_WINDOWS} windows of the 7 test CSVs: "
          f"{BENCHMARK_WINDOWS * mean_ms / 1e3:.1f} s (derived: "
          f"{BENCHMARK_WINDOWS} x the mean window above, not measured)")
    del state
    torch.cuda.empty_cache()
    return launches["voxel_vote"], {
        "ms_per_window": mean_ms, "windows_per_s": 1e3 / mean_ms,
        "peak_gib": peak / 2**30, "parts_ms": mean_parts}


def phase_infer_card_vs_cpu(torch):
    """The same seeded weights and windows at narrow UNet widths through
    infer_window on the CPU (plain voxel vote) and on the card (kernel)."""
    import tempfile
    from pathlib import Path

    from motionpriorcmax_tpu_torch.cli.main import infer_window

    norm = DSEC_INFERENCE_CONFIG["data"]["norm_type"]
    arrays, rect, rows, _ = infer_sequence_arrays(22, 2)
    flows = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_timestamp_csv(Path(tmp) / "seq.csv", rows)
        seq = infer_sequence_at(Path(tmp) / "zurich_city_98_z",
                                Path(tmp) / "seq.csv", arrays, rect)
        windows = [seq[i]["events"] for i in range(len(seq))]
    for dev in ("cpu", "cuda"):
        state, cfg = infer_state(torch, dev, unet_widths=(8, 16, 16, 32, 32))
        flows[dev] = [infer_window(state, cfg, ev, norm, torch.device(dev))
                      for ev in windows]
    worst = 0.0
    for i, (a, b) in enumerate(zip(flows["cpu"], flows["cuda"])):
        if not np.isfinite(b).all():
            fail(f"window {i}: non-finite flow on the card")
        scale = max(1.0, float(np.abs(a).max()))
        err = float(np.abs(a - b).max())
        worst = max(worst, err / scale)
        print(f"[infer-card-vs-cpu] window {i} ({len(windows[i])} packed "
              f"events), f32 UNet [8, 16, 16, 32, 32] 480x640: max |flow "
              f"card - cpu| {err:.3e} (bound {TOL_CARD_VS_CPU * scale:.3e} = "
              f"{TOL_CARD_VS_CPU:g} x max(1, max |cpu flow|))")
        if not err <= TOL_CARD_VS_CPU * scale:
            fail("card and CPU inference disagree")
    return worst


# ---------------------------------------------------------------------------
# flow-train's remaining configuration values: grid KNN, L1 softmax,
# capacity buckets
# ---------------------------------------------------------------------------

PART_B_STEPS = 2                   # 1 warm-up + 1 timed
# The L1 softmax interpolation is plain PyTorch (JAX's Pallas kernel is
# l2 only): no softmax-interp launch.
L1_STEP = {**SOFTMAX_STEP, "softmax_interp_fwd": 0, "softmax_interp_bwd": 0}
L1_VAL = {**SOFTMAX_VAL, "softmax_interp_fwd": 0}
BUCKETS = (1 << 19, 1 << 20)       # --event-capacity-buckets 524288,1048576
BUCKET_EVENTS = 300_000            # raw events per window: below a half bucket


def phase_buckets(torch, scfg, sloss, smi_line):
    """One batch through the DataLoader with capacity buckets (2^19, 2^20)
    from 14 windows of BUCKET_EVENTS events: each polarity half padded to
    2^18 (half the smaller bucket), the batch at 2^19 < 2^20; then
    train_flow's softmax / device-voxel step on it."""
    from motionpriorcmax_tpu_torch.data.loader import DataLoader

    h, w = scfg.image_shape
    b = DSEC_CONFIG["data"]["batch_size"]
    samples = flow_samples(8, b, BUCKET_EVENTS, h, w, scfg.num_bins,
                           gt=True, voxel=False)
    t0 = time.perf_counter()
    loader = DataLoader(samples, batch_size=b, capacity=FLOW_CAPACITY,
                        shuffle=False,
                        num_workers=DSEC_CONFIG["data"]["num_workers"],
                        polarity_aware=True, capacity_buckets=BUCKETS,
                        lut_cell_sort_params=(
                            sloss.image_shape, sloss.num_bins,
                            sloss.lut_superpixel_size),
                        pin_memory=True)
    batch = next(iter(loader))
    dt = time.perf_counter() - t0
    m, npos = batch["events"].shape[1], batch["num_pos_events"]
    print(f"[buckets] {b} windows of {BUCKET_EVENTS} events, buckets "
          f"{list(BUCKETS)}: batch events {list(batch['events'].shape)}, "
          f"num_pos_events {npos}, {dt:.2f} s through the loader")
    if not (m == BUCKETS[0] and npos == BUCKETS[0] // 2):
        fail(f"expected a batch of {BUCKETS[0]} events, {BUCKETS[0] // 2} "
             f"per half; got {m}, {npos}")
    train = {k: v for k, v in batch.items()
             if k not in ("forward_flow", "flow_valid")}
    return phase_flow_train(torch, scfg, sloss, train, batch, smi_line,
                            SOFTMAX_STEP, SOFTMAX_VAL, tag="bucket-train",
                            n_steps=PART_B_STEPS)


# ---------------------------------------------------------------------------
# flow-train's epoch image panels; RAFT-Spline compute_dtype bfloat16
# ---------------------------------------------------------------------------

PANEL_SAMPLES = 5                  # utils/image_logging.py's N_SAMPLES
PANEL_IMAGES = ("0_unwarped", "1_gt_iwe", "2_iwe", "3_gt_flow", "4_flow")
# Launches per render of one sample (the unwarped image's vote, the eval
# step's two polarity halves and its LUT gather, the GT IWE's two halves
# on events in collate order, one exact KNN for the step and one for the
# GT IWE, the UNet's eval-mode norms in the step and in the predicted
# flow), and with knn_method softmax and the voxel grid voted in the
# render (one softmax forward for the step and one for the GT IWE, one
# voxel vote for both the step and the predicted flow).
RENDER_EXACT = {"iwe_vote_fwd": 5, "lut_gather_fwd": 1, "knn_topk": 2,
                "flax_bn_apply": 2 * UNET_NORMS}
RENDER_SOFTMAX = {**RENDER_EXACT, "softmax_interp_fwd": 2, "voxel_vote": 1,
                  "knn_topk": 0}
# Card vs CPU render at the test geometry: each image against its CPU
# version, relative to the image's largest |value| (the f32 step of phase
# 13 agrees to ~1e-6; the panel's IWEs are that step's).
TOL_RENDER = 1e-4
# bf16 RAFT, card vs CPU at the test geometry: the tolerances of
# tests/test_torch_raft_bf16.py (port vs JAX on the CPU): cuDNN and the
# CPU's convolutions sum in other orders, and a bf16 rounding that lands a
# step apart is carried on by the norms and the GRU.
TOL_BF16_FORWARD = 5e-2            # of the largest upsampled value
TOL_BF16_LOSS = 1e-3               # relative
MIN_BF16_GRAD_COS = 0.95           # cosine of all the gradients
BF16_RAFT = {"compute_dtype": "bfloat16", "corr_dtype": "bfloat16"}


def phase_panels(torch, cfg, loss_cfg, samples, train_batch, val_batch,
                 smi_line, want_render, tag):
    """One train_flow epoch at full width (1 train step, the image panel of
    PANEL_SAMPLES of `samples`, the val pass), the panel's samples collated
    one by one as the CLI's val loader collates them (DataLoader.collate:
    capacity 2^20, polarity packing, LUT-cell sort).  Fails unless the 25
    PNGs are written, read back as 480 x 640 RGB, and every render launches
    `want_render`.  Returns (launches per render, mean render ms)."""
    import tempfile

    from motionpriorcmax_tpu_torch.data.loader import DataLoader
    from motionpriorcmax_tpu_torch.training import loop
    from motionpriorcmax_tpu_torch.training.loop import train_flow
    from motionpriorcmax_tpu_torch.utils import profiling
    from motionpriorcmax_tpu_torch.utils.png16 import read_png_rgb

    h, w = cfg.image_shape
    loader = DataLoader(samples, batch_size=1, capacity=FLOW_CAPACITY,
                        shuffle=False, polarity_aware=True,
                        pos_capacity=FLOW_CAPACITY // 2,
                        lut_cell_sort_params=(
                            loss_cfg.image_shape, loss_cfg.num_bins,
                            loss_cfg.lut_superpixel_size),
                        pin_memory=True)
    renders, collates, panel_s = [], [], []
    make_render = loop.make_flow_render_fn
    log_images = loop.log_flow_epoch_images

    def timed_render(*args, **kwargs):
        render = make_render(*args, **kwargs)

        def run(batch):
            torch.cuda.synchronize()
            before = launch_counts()
            t0 = time.perf_counter()
            out = render(batch)
            torch.cuda.synchronize()
            renders.append(((time.perf_counter() - t0) * 1e3,
                            {k: n - before[k]
                             for k, n in launch_counts().items()}))
            return out
        return run

    def timed_collate(items):
        t0 = time.perf_counter()
        batch = loader.collate(items)
        collates.append((time.perf_counter() - t0) * 1e3)
        return batch

    def timed_log(*args, **kwargs):
        t0 = time.perf_counter()
        log_images(*args, **kwargs)
        panel_s.append(time.perf_counter() - t0)

    npos = train_batch["num_pos_events"]
    loop.make_flow_render_fn, loop.log_flow_epoch_images = (timed_render,
                                                            timed_log)
    try:
        with tempfile.TemporaryDirectory() as workdir:
            profiling.reset()
            train_flow(cfg, loss_cfg, [train_batch], [val_batch], workdir,
                       device="cuda", max_epochs=1, num_pos_events=npos,
                       log_every=1, seed=0, image_log_dataset=samples,
                       image_log_collate=timed_collate)
            launches = launch_counts()
            names = sorted(os.listdir(f"{workdir}/images"))
            images = [read_png_rgb(f"{workdir}/images/{n}") for n in names]
    finally:
        loop.make_flow_render_fn, loop.log_flow_epoch_images = (make_render,
                                                                log_images)
    want_names = sorted(f"{1:06d}_{i:02d}_val_{n}.png"
                        for i in range(PANEL_SAMPLES) for n in PANEL_IMAGES)
    if names != want_names:
        fail(f"[{tag}] panel files {names}, expected {want_names}")
    bad = [n for n, im in zip(names, images)
           if im.shape != (h, w, 3) or im.dtype != np.uint8]
    if bad:
        fail(f"[{tag}] panel images that do not read back as {h}x{w} RGB "
             f"uint8: {bad}")
    flat = [n for n, im in zip(names, images) if im.min() == im.max()]
    per_render = [c for _, c in renders]
    if len(renders) != PANEL_SAMPLES or any(
            launched(c) != launched(want_render) for c in per_render):
        fail(f"[{tag}] expected {PANEL_SAMPLES} renders of "
             f"{launched(want_render)} launches, got "
             f"{[launched(c) for c in per_render]}")
    render_ms = [t for t, _ in renders]
    mean_ms = float(np.mean(render_ms[1:]))
    write_ms = (panel_s[0] * 1e3 - sum(collates) - sum(render_ms)) \
        / PANEL_SAMPLES
    print(f"[{tag}] dsec.yaml {h}x{w} {cfg.compute_dtype} UNet, knn_method "
          f"{loss_cfg.knn_method}, "
          f"{'host' if 'voxel' in train_batch else 'device'} voxel: "
          f"{len(names)} PNGs read back ({h}x{w} RGB; single-colour: "
          f"{flat or 'none'}); per sample: render "
          f"{', '.join(f'{t:.1f}' for t in render_ms)} ms (mean after the "
          f"first {mean_ms:.1f}), collate "
          f"{', '.join(f'{t:.1f}' for t in collates)} ms, colorize + PNG "
          f"~{write_ms:.1f} ms; the panel {panel_s[0]:.2f} s; launches per "
          f"render {launched(want_render)}; the epoch's launches "
          f"{launched(launches)}; card {smi_line}")
    return launched(want_render), mean_ms


def phase_panels_card_vs_cpu(torch):
    """One sample's render at the test geometry (f32 UNet) on the CPU
    (plain versions) and on the card (kernels), same weights, times and
    collated sample, exact KNN with the host voxel and softmax with the
    voxel grid voted in the render.  Returns the largest relative
    difference."""
    from motionpriorcmax_tpu_torch.data.loader import DataLoader
    from motionpriorcmax_tpu_torch.training import trajectory_net as ttn
    from motionpriorcmax_tpu_torch.training.loop import make_flow_render_fn

    h, w, nb = 32, 48, 15
    times = torch.cat([torch.tensor([0.37]),
                       (torch.arange(nb) + 0.5) / nb]).float()
    worst = 0.0
    for knn, device_voxel, want in (("exact", False, RENDER_EXACT),
                                    ("softmax", True, RENDER_SOFTMAX)):
        cfg, loss_cfg = flow_configs(
            {**DSEC_CONFIG, "common": {**DSEC_CONFIG["common"], "height": h,
                                       "width": w},
             "loss": {**DSEC_CONFIG["loss"], "knn_method": knn}},
            compute_dtype="float32", unet_widths=[8, 16, 16, 32, 32])
        sample = flow_samples(5, 1, 2500, h, w, nb, gt=True,
                              voxel=not device_voxel)
        batch = DataLoader(sample, batch_size=1, capacity=4096,
                           polarity_aware=True, pos_capacity=2048,
                           lut_cell_sort_params=(
                               (h, w), nb, loss_cfg.lut_superpixel_size)
                           ).collate(sample)
        out = {}
        before = launch_counts()
        for dev in ("cpu", "cuda"):
            state = ttn.create_train_state(cfg, dev,
                                           torch.Generator().manual_seed(1))
            out[dev] = make_flow_render_fn(state, loss_cfg,
                                           times=times)(batch)
        launches = launched({k: n - before[k]
                             for k, n in launch_counts().items()})
        if set(out["cpu"]) != set(out["cuda"]) or len(out["cpu"]) != 5:
            fail(f"render outputs {sorted(out['cpu'])} / "
                 f"{sorted(out['cuda'])}")
        diffs = {k: float(np.abs(out["cuda"][k] - v).max()
                          / max(np.abs(v).max(), 1e-30))
                 for k, v in out["cpu"].items()}
        worst = max(worst, *diffs.values())
        print(f"[panel-card-vs-cpu] f32 render {h}x{w}, knn_method {knn}, "
              f"{'device' if device_voxel else 'host'} voxel: max |diff| / "
              f"max |cpu| per image "
              f"{ {k: f'{v:.2e}' for k, v in diffs.items()} } (bound "
              f"{TOL_RENDER:g}); card launches {launches}")
        if not max(diffs.values()) <= TOL_RENDER:
            fail("card and CPU renders disagree")
        if launches != launched(want):
            fail(f"the card's render launched {launches}, not "
                 f"{launched(want)}")
    return worst


def lookup_levels(pyramid, coords):
    """(corr_l, cx, cy, chan_off) per level as lookup_corr_pyramid hands
    them to the kernels, and the slab's channel count."""
    from motionpriorcmax_tpu_torch.models.raft_spline.corr import \
        lookup_inputs

    levels, off = [], 0
    for corr_l, cx, cy in lookup_inputs(pyramid, coords):
        levels.append((corr_l, cx, cy, off))
        off += corr_l.shape[0] * K
    return levels, off


@contextlib.contextmanager
def first_lookup(torch, store):
    """Keep the first pyramid lookup's per-level inputs (the volumes and
    their window centres, detached) in `store` while the model runs; the
    lookup itself is unchanged."""
    from motionpriorcmax_tpu_torch.models.raft_spline import raft

    inner = raft.lookup_corr_pyramid

    def spy(pyramid, coords, radius=RADIUS):
        if "levels" not in store:
            store["levels"], store["c_total"] = lookup_levels(
                [(idx, c.detach()) for idx, c in pyramid], coords.detach())
        return inner(pyramid, coords, radius)

    raft.lookup_corr_pyramid = spy
    try:
        yield store
    finally:
        raft.lookup_corr_pyramid = inner


def phase_bf16_lookup(torch, levels, c_total, tag):
    """Row 1 on a request's bf16 pyramid (all levels, one launch) against
    its plain version; its time, beside the same windows on the volumes
    widened to f32, and its bytes bound.  Returns the kernels-line
    numbers."""
    from motionpriorcmax_tpu_torch.ops.cuda import corr_window as cw

    corr0 = levels[0][0]
    b, (h1, w1) = corr0.shape[1], (H // 8, W // 8)
    out_k = torch.full((b, c_total, h1, w1), float("nan"), device="cuda")
    out_p = torch.full_like(out_k, float("nan"))
    cw.corr_window_lookup_levels(levels, RADIUS, out_k)
    cw.corr_window_lookup_levels_plain(levels, RADIUS, out_p)
    torch.cuda.synchronize()
    err = check_close(f"fused lookup of {len(levels)} levels, B={b}, "
                      f"{str(corr0.dtype)[6:]} volumes of the path", out_k,
                      out_p, TOL_KERNEL, tag)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    levels32 = [(c.float(), cx, cy, off) for c, cx, cy, off in levels]
    ms = timers(torch, lambda: cw.corr_window_lookup_levels(
        levels, RADIUS, out_k), flush)[1]
    ms32 = timers(torch, lambda: cw.corr_window_lookup_levels(
        levels32, RADIUS, out_k), flush)[1]
    nbytes = sum(needed_bytes(torch, c, cx, cy) for c, cx, cy, _ in levels)
    bound = nbytes / H100_BYTES_PER_S * 1e3
    del flush, levels32, out_k, out_p
    torch.cuda.empty_cache()
    print(f"[{tag}] one refinement iteration (1 launch, levels 1-4) on the "
          f"bf16 pyramid: card {ms * 1e3:.1f} us, the same windows on f32 "
          f"volumes {ms32 * 1e3:.1f} us, bound {bound * 1e3:.1f} us "
          f"({nbytes / 1e6:.1f} MB needed, bytes-bound)")
    return {"bf16_max_abs_err": err, "bf16_card_ms": ms,
            "bf16_f32_volumes_card_ms": ms32, "bf16_bound_ms": bound}


def phase_bf16_bwd(torch, levels, c_total, tag):
    """Row 2 on a train step's bf16 pyramid, level by level, against its
    plain version with a random cotangent; its time per refinement
    iteration (4 launches) beside the same on the volumes widened to f32.
    Returns the kernels-line numbers."""
    from motionpriorcmax_tpu_torch.ops.cuda import corr_window as cw

    b = levels[0][0].shape[1]
    gen = torch.Generator(device="cuda").manual_seed(410)
    g = torch.randn(b, c_total, H // 8, W // 8, device="cuda", generator=gen)
    err16 = err32 = 0.0
    for lvl, (corr, cx, cy, off) in enumerate(levels):
        got = cw.corr_window_lookup_bwd(corr, cx, cy, RADIUS, g, off)
        want = cw.corr_window_lookup_bwd_plain(corr, cx, cy, RADIUS, g, off)
        torch.cuda.synchronize()
        name = (f"level {lvl + 1} map {corr.shape[-2]}x{corr.shape[-1]} "
                f"B={b} {str(corr.dtype)[6:]} volume of the path")
        err16 = max(err16, check_close(f"{name} d corr", got[0].float(),
                                       want[0].float(), TOL_BWD_BF16, tag))
        for label, a, w in (("d cx", got[1], want[1]),
                            ("d cy", got[2], want[2])):
            err32 = max(err32, check_close(f"{name} {label}", a, w, TOL_BWD,
                                           tag))
        del got, want
    torch.cuda.empty_cache()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def iteration(lv):
        for corr, cx, cy, off in lv:
            cw.corr_window_lookup_bwd(corr, cx, cy, RADIUS, g, off)

    ms = timers(torch, lambda: iteration(levels), flush)[1]
    levels32 = [(c.float(), cx, cy, off) for c, cx, cy, off in levels]
    ms32 = timers(torch, lambda: iteration(levels32), flush)[1]
    bound = sum(bwd_bound(torch, c, cx, cy)[1] for c, cx, cy, _ in levels)
    bound32 = sum(bwd_bound(torch, c, cx, cy)[1]
                  for c, cx, cy, _ in levels32)
    del flush, levels32, g
    torch.cuda.empty_cache()
    print(f"[{tag}] one refinement iteration's backward (4 launches) on the "
          f"bf16 pyramid: card {ms * 1e3:.1f} us (bytes bound "
          f"{bound * 1e3:.1f} us), on f32 volumes {ms32 * 1e3:.1f} us "
          f"(bound {bound32 * 1e3:.1f} us)")
    return {"bf16_max_abs_err": err16, "bf16_d_coords_max_abs_err": err32,
            "bf16_card_ms": ms, "bf16_f32_volumes_card_ms": ms32,
            "bf16_bound_ms": bound, "bf16_f32_volumes_bound_ms": bound32}


def phase_bf16_card_vs_cpu(torch):
    """The bf16 model at the test geometry on the CPU (plain versions) and
    the card (kernels), same weights and inputs: the forward, and one
    self-supervised raft_train_step (loss and the gradients' direction)."""
    from motionpriorcmax_tpu_torch.losses import FocusLossConfig
    from motionpriorcmax_tpu_torch.models.raft_spline import RAFTSplineConfig
    from motionpriorcmax_tpu_torch.training import raft_spline as trs
    from motionpriorcmax_tpu_torch.training.loop import to_device

    h = w = 32
    cfg = RAFTSplineConfig(nbins_context=5, nbins_correlation=3,
                           bezier_degree=2, ev_target_indices=(2, 4),
                           ev_levels=(1, 2), iters=2, **BF16_RAFT)
    loss_cfg = FocusLossConfig(image_shape=(h, w), num_bins=5, num_knn=4,
                               smooth_weight=0.01, lut_superpixel_size=4,
                               smooth_type="on_flow_to_next")
    host, _ = tiny_traj_batches(cfg, h, w)
    times = torch.tensor([0.37, 0.1, 0.3, 0.5, 0.7, 0.9])
    ups, steps = {}, {}
    for dev in ("cpu", "cuda"):
        state = trs.create_raft_train_state(cfg, trs.RAFTTrainConfig(), dev,
                                            torch.Generator().manual_seed(1))
        batch = to_device(host, torch.device(dev))
        with torch.no_grad():
            _, up = state.model.eval()(batch["ev_repr"], test_mode=True)
        ups[dev] = up.float().cpu()
        logs = trs.raft_train_step(state, batch, None, loss_cfg,
                                   host["num_pos_events"], times=times)
        steps[dev] = (float(logs["train_losses/total"]), torch.cat(
            [p.grad.detach().float().cpu().reshape(-1)
             for p in state.model.parameters()]))
    fwd_rel = float((ups["cuda"] - ups["cpu"]).abs().max()
                    / ups["cpu"].abs().max())
    (l_c, g_c), (l_g, g_g) = steps["cpu"], steps["cuda"]
    loss_rel = abs(l_g - l_c) / abs(l_c)
    cos = float((g_c * g_g).sum() / (g_c.norm() * g_g.norm()))
    print(f"[bf16-card-vs-cpu] bf16 compute + bf16 corr, {h}x{w} B=2, "
          f"{cfg.iters} iterations: forward max |diff| / max |cpu| "
          f"{fwd_rel:.3e} (bound {TOL_BF16_FORWARD:g}); raft_train_step loss "
          f"rel diff {loss_rel:.3e} (bound {TOL_BF16_LOSS:g}), gradient "
          f"cosine {cos:.5f} (at least {MIN_BF16_GRAD_COS:g})")
    if not (fwd_rel <= TOL_BF16_FORWARD and loss_rel <= TOL_BF16_LOSS
            and cos >= MIN_BF16_GRAD_COS):
        fail("card and CPU bf16 RAFT-Spline disagree")
    return fwd_rel


# -- multi-process training: a world of one over NCCL, two ranks over gloo --

PAR_RANKS = 2                     # processes sharing the one card (gloo)
PAR_TIMEOUT_S = 480               # the two-rank world, start to finish
PAR_LR = 0.05                     # SGD: the update is linear in the gradient
PAR_STEPS = 3                     # the compared step + 2 timed
# The sharded step against the single-process step of the global batch,
# both this port on the card: the loss to PAR_LOSS_RTOL, and each leaf of
# the weights (BatchNorm statistics included) after the compared SGD step
# to PAR_UPDATE_RTOL of that leaf's update in the single-process step,
# max|w_sharded - w_single| <= r max|w_single - w_before| (an update under
# 1e-3 of the case's largest counts as that much), a few times the
# readings of sound runs on an H100 (loss 1.0e-7-6.7e-7 relative,
# weights 1.1e-3-2.5e-3 of the update).  A control step on each rank,
# every group sum taken out (each rank's loss of its own share and
# BatchNorm statistics of its own rows, the gradients still averaged over
# the world: DDP's function, not the global batch's), must leave the
# weights' bound (it read 0.15-8854 of the update).
PAR_LOSS_RTOL = {"flow": 3e-6, "traj": 1e-6}
PAR_UPDATE_RTOL = {"flow": 1e-2, "traj": 5e-3}
# (name, path, (data, event), batch, launches per step)
PAR_CASES = (
    ("flow-1x2-sorted", "flow", (1, 2), "sorted", SOFTMAX_STEP),
    ("flow-2x1-unsorted", "flow", (2, 1), "unsorted", UNSORTED_STEP),
    ("traj-2x1", "traj", (2, 1), "traj", TRAJ_STEP),
    ("traj-1x2", "traj", (1, 2), "traj", TRAJ_STEP),
)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_nccl_world(torch, cfg, loss_cfg, train_batch, val_batch, smi_line,
                     plain_ms):
    """Phase 43: the CLI's process group on the card, a world of one over
    NCCL (initialize_distributed, make_mesh), through train_flow's sharded
    path with phase 11's configuration and batch.  Returns the launches."""
    import torch.distributed as dist

    from motionpriorcmax_tpu_torch.parallel import (initialize_distributed,
                                                    make_mesh)

    # The sealed machine may have no interface but the loopback one; a
    # world of one on one host bootstraps NCCL over it.
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dev = initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                                 device="cuda", timeout_s=300)
    try:
        mesh = make_mesh()
        if mesh.backend != "nccl" or dev.type != "cuda":
            fail(f"the world of one runs {mesh.backend} on {dev}")
        launches, ms = phase_flow_train(
            torch, cfg, loss_cfg, train_batch, val_batch, smi_line,
            EXACT_STEP, EXACT_VAL, tag="nccl-world1", mesh=mesh)
    finally:
        dist.destroy_process_group()
    print(f"[nccl-world1] step {ms:.1f} ms in a world of one over NCCL "
          f"against {plain_ms:.1f} ms without a process group (phase 11, "
          f"this call); card {smi_line}")
    return launches


def par_flow_state(torch, cfg):
    from motionpriorcmax_tpu_torch.training.trajectory_net import \
        create_train_state

    state = create_train_state(cfg, "cuda", torch.Generator().manual_seed(0))
    state.optimizer = torch.optim.SGD(state.model.parameters(), lr=PAR_LR)
    return state


def par_traj_state(torch):
    from motionpriorcmax_tpu_torch.cli.main import traj_train_configs
    from motionpriorcmax_tpu_torch.training.raft_spline import \
        create_raft_train_state

    cfg, tc, loss_cfg = traj_train_configs(TAB2L5_CONFIG, (H, W),
                                           TRAJ_SCHEDULE_STEPS)
    state = create_raft_train_state(cfg, tc, "cuda",
                                    torch.Generator().manual_seed(0))
    state.optimizer = torch.optim.SGD(state.model.parameters(), lr=PAR_LR)
    state.scheduler = None
    return state, loss_cfg


def par_inputs(torch, path, scfg, sloss):
    """(state, step(state, device batch, mesh) -> loss) of a case's path:
    seed-0 weights and SGD, t_ref from a torch.Generator seeded 11."""
    from motionpriorcmax_tpu_torch.losses import get_reconstruction_times
    from motionpriorcmax_tpu_torch.training.raft_spline import \
        raft_train_step
    from motionpriorcmax_tpu_torch.training.trajectory_net import train_step

    if path == "flow":
        state = par_flow_state(torch, scfg)
        times = get_reconstruction_times(
            sloss, torch.Generator().manual_seed(11), "cuda")

        def step(st, batch, npos, mesh):
            return train_step(st, batch, None, scfg, sloss, npos, times=times,
                              mesh=mesh)["train_losses/total"]
        return state, step
    state, loss_cfg = par_traj_state(torch)
    times = get_reconstruction_times(
        loss_cfg, torch.Generator().manual_seed(11), "cuda")

    def step(st, batch, npos, mesh):
        return raft_train_step(st, batch, None, loss_cfg, npos, times=times,
                               mesh=mesh)["train_losses/total"]
    return state, step


def par_model_state(state):
    return {k: v.detach().to("cpu", copy=True)
            for k, v in state.model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def per_rank_loss(mesh):
    """The control of phases 44-45: `mesh` with its group sums taken out,
    the gradient average kept."""
    import copy

    ctl = copy.copy(mesh)
    ctl.data_sum = ctl.event_sum = lambda x: x
    return ctl


def update_excess(got, before, after):
    """(worst ratio, its leaf, max|got - after|, max|after - before|) over
    the leaves: max|got - after| over the leaf's own single-process update
    max|after - before|, floored at 1e-3 of the largest leaf update."""
    ups = {k: float((after[k].double() - before[k].double()).abs().max())
           for k in after}
    floor = 1e-3 * max(ups.values())
    worst = (-1.0, None, 0.0, 0.0)
    for k, want in after.items():
        d = float((got[k].double() - want.double()).abs().max())
        r = d / max(ups[k], floor)
        if r > worst[0]:
            worst = (r, k, d, ups[k])
    return worst


def rank_main(rank: int, port: int, workdir: str) -> int:
    """One rank of phases 44-46 (`chip_smoke.py --rank R PORT DIR`): gloo
    over CUDA tensors, the rank's card cuda:0 shared with the other rank.
    Per case: the rank's share of the global batch (parallel.shard_batch),
    PAR_STEPS sharded steps from the seed-0 weights, the first one's loss
    and weights kept, launches, step ms, peak memory and all-reduced bytes
    per step, and the control step (`per_rank_loss`) from the seed-0
    weights; then MetricBank.reduce_across_processes and train_flow's
    rank-0-only writes.  Writes <DIR>/rank<R>.pt."""
    import torch

    from motionpriorcmax_tpu_torch.metrics import MetricBank
    from motionpriorcmax_tpu_torch.parallel import (initialize_distributed,
                                                    make_mesh, shard_batch)
    from motionpriorcmax_tpu_torch.training.loop import to_device, train_flow
    from motionpriorcmax_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    dev = initialize_distributed(f"127.0.0.1:{port}", PAR_RANKS, rank,
                                 backend="gloo", device="cuda",
                                 timeout_s=PAR_TIMEOUT_S)
    batches = {name: {k: np.load(f"{workdir}/{name}.{k}.npy")
                      for k in json.load(open(f"{workdir}/{name}.json"))}
               for name in ("sorted", "unsorted", "traj")}
    scfg, sloss = flow_configs({**DSEC_CONFIG, "loss": {
        **DSEC_CONFIG["loss"], "knn_method": "softmax"}})
    out = {"cases": {}, "setup_s": time.perf_counter() - t0}
    for name, path, shape, which, _ in PAR_CASES:
        mesh = make_mesh(*shape)
        state, step = par_inputs(torch, path, scfg, sloss)
        batch = batches[which]
        npos = int(batch["num_pos_events"])
        local = to_device(shard_batch(mesh, batch, npos), dev)
        if any(v.device != dev for v in local.values()):
            fail(f"rank {rank}: the batch is not on {dev}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec = {"launches": [], "ms": [], "bytes": []}
        for i in range(PAR_STEPS):
            profiling.reset()
            b0 = mesh.reduced_bytes
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss = float(step(state, local, npos, mesh))
            torch.cuda.synchronize()
            rec["ms"].append((time.perf_counter() - t1) * 1e3)
            rec["launches"].append(launch_counts())
            rec["bytes"].append(mesh.reduced_bytes - b0)
            if i == 0:
                rec["loss"] = loss
                rec["state"] = par_model_state(state)
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        rec["local_batch"] = tuple(local["events"].shape)
        del state, step
        torch.cuda.empty_cache()
        state, step = par_inputs(torch, path, scfg, sloss)
        rec["control_loss"] = float(step(state, local, npos,
                                         per_rank_loss(mesh)))
        rec["control_state"] = par_model_state(state)
        out["cases"][name] = rec
        del state, step, local
        torch.cuda.empty_cache()

    # Phase 46: the metric bank over the two ranks, and train_flow's
    # writes (rank 0 alone) on the (2, 1) mesh, a workdir per rank.
    bank = MetricBank()
    bank.update_device({"epe": torch.tensor(float(rank + 1), device=dev)})
    out["bank"] = bank.reduce_across_processes().compute()
    mesh = make_mesh(2, 1)
    local = shard_batch(mesh, batches["unsorted"],
                        int(batches["unsorted"]["num_pos_events"]))
    rundir = f"{workdir}/run{rank}"
    res = train_flow(scfg, sloss, [local], [local], rundir, device=dev,
                     max_epochs=1, num_pos_events=int(local["num_pos_events"]),
                     log_every=1, seed=0, mesh=mesh)
    out["train_flow"] = res
    out["written"] = sorted(
        os.path.relpath(os.path.join(d, f), rundir)
        for d, _, files in os.walk(rundir) for f in files)
    torch.save(out, f"{workdir}/rank{rank}.pt")
    import torch.distributed as dist

    dist.destroy_process_group()
    print(f"[parallel rank {rank}] done in {time.perf_counter() - t0:.1f} s")
    return 0


def phase_parallel(torch, scfg, sloss, sorted_batch, unsorted_batch,
                   traj_batch, smi_line):
    """Phases 44-46: two ranks on the one card over gloo (CUDA tensors, the
    collectives through the host), each a process of this script
    (`--rank`): the single-process step of each case on the card here,
    then the world, then each rank's first step against it.  Two ranks on
    one card show that the kernels run on data and event shards and that
    the sharded step gives the same numbers; their times are not a
    scaling measurement.  Returns {case: [launches per step of each
    rank]}."""
    import tempfile

    with tempfile.TemporaryDirectory() as workdir:
        for name, batch in (("sorted", sorted_batch),
                            ("unsorted", unsorted_batch),
                            ("traj", traj_batch)):
            keys = [k for k, v in batch.items() if k in (
                "events", "lut_cell_ends", "ev_repr", "num_pos_events")]
            for k in keys:
                np.save(f"{workdir}/{name}.{k}.npy", np.asarray(batch[k]))
            with open(f"{workdir}/{name}.json", "w") as fh:
                json.dump(keys, fh)
        # The single-process steps on the global batches.
        from motionpriorcmax_tpu_torch.training.loop import to_device

        refs, by_batch = {}, {}
        t0 = time.perf_counter()
        for name, path, _, which, _ in PAR_CASES:
            if which not in by_batch:
                batch = {"sorted": sorted_batch, "unsorted": unsorted_batch,
                         "traj": traj_batch}[which]
                state, step = par_inputs(torch, path, scfg, sloss)
                before = par_model_state(state)
                loss = float(step(state, to_device(batch, "cuda"),
                                  int(batch["num_pos_events"]), None))
                by_batch[which] = (loss, before, par_model_state(state))
                del state, step
                torch.cuda.empty_cache()
            refs[name] = by_batch[which]
        print(f"[parallel] single-process reference steps "
              f"{time.perf_counter() - t0:.1f} s")
        port = free_port()
        env = dict(os.environ)
        logs = [open(f"{workdir}/rank{r}.log", "w+") for r in
                range(PAR_RANKS)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             str(port), workdir], stdout=logs[r], stderr=subprocess.STDOUT,
            env=env) for r in range(PAR_RANKS)]
        try:
            for p in procs:
                p.wait(timeout=max(1.0, PAR_TIMEOUT_S
                                   - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for r, fh in enumerate(logs):
            fh.seek(0)
            text = fh.read()
            fh.close()
            print(f"[parallel] rank {r} exit {procs[r].returncode}, its "
                  f"output's end:")
            for line in text.splitlines()[-25:]:
                print(f"[parallel]   {line}")
        if any(p.returncode != 0 for p in procs):
            fail(f"a rank of the two-rank world failed or ran out its "
                 f"{PAR_TIMEOUT_S} s: exit codes "
                 f"{[p.returncode for p in procs]}")
        outs = [torch.load(f"{workdir}/rank{r}.pt", weights_only=False)
                for r in range(PAR_RANKS)]
    print(f"[parallel] the world of {PAR_RANKS} ranks on one card (gloo) "
          f"ran {wall:.1f} s, start to exit")
    launches, faults = {}, []
    for name, path, shape, which, want in PAR_CASES:
        ref_loss, before, after = refs[name]
        tol_loss, tol_up = PAR_LOSS_RTOL[path], PAR_UPDATE_RTOL[path]
        tag = f"parallel-{name}"
        largest = max(float((after[k] - before[k]).abs().max())
                      for k in after)
        launches[name] = []
        for r, out in enumerate(outs):
            rec = out["cases"][name]
            want_all = {k: want.get(k, 0) for k in rec["launches"][0]}
            if any(c != want_all for c in rec["launches"]):
                faults.append(f"{tag} rank {r}: expected {want_all} launches "
                              f"per step, got {rec['launches']}")
            launches[name].append(rec["launches"][0])
            rel = abs(rec["loss"] - ref_loss) / abs(ref_loss)
            ratio, key, diff, up = update_excess(rec["state"], before, after)
            c_rel = abs(rec["control_loss"] - ref_loss) / abs(ref_loss)
            c_ratio, c_key, c_diff, c_up = update_excess(
                rec["control_state"], before, after)
            print(f"[{tag}] rank {r} mesh {shape} local batch "
                  f"{rec['local_batch']}: loss {rec['loss']:.6f} against "
                  f"the single-process {ref_loss:.6f} (rel diff {rel:.2e}, "
                  f"bound {tol_loss:g}); weights after the SGD step: "
                  f"largest |diff| / the leaf's update {ratio:.3e} at {key} "
                  f"(|diff| {diff:.3e}, update {up:.3e}; bound "
                  f"{tol_up:g}; the largest leaf update {largest:.3e}); "
                  f"control (per-rank loss, gradients averaged): loss rel "
                  f"diff {c_rel:.2e}, weights {c_ratio:.3e} at {c_key} "
                  f"(|diff| {c_diff:.3e}, update {c_up:.3e}; must exceed "
                  f"{tol_up:g}); step ms "
                  f"{[round(x, 1) for x in rec['ms']]} (first: the compared "
                  f"step), peak memory {rec['peak_gib']:.2f} GiB, bytes "
                  f"all-reduced per step {rec['bytes'][-1]}, launches per "
                  f"step {rec['launches'][-1]}; card {smi_line}")
            if not rel <= tol_loss or not ratio <= tol_up:
                faults.append(f"{tag} rank {r}: the sharded step left the "
                              "single-process step's bounds")
            if not c_ratio > tol_up:
                faults.append(f"{tag} rank {r}: the weights' bound does "
                              "not tell the per-rank loss from the global "
                              "batch's")
    # Phase 46.
    for r, out in enumerate(outs):
        print(f"[parallel-bank] rank {r}: reduce_across_processes of "
              f"epe 1 and 2 -> {out['bank']}; train_flow wrote "
              f"{out['written']}, returned {out['train_flow']}")
        if abs(out["bank"].get("epe", 0.0) - 1.5) > 1e-12:
            fail(f"rank {r}: the reduced metric is {out['bank']}, not 1.5")
    w0, w1 = outs[0]["written"], outs[1]["written"]
    if w1 or "scalars.jsonl" not in w0 or not any(
            f.startswith("checkpoints/step_") for f in w0):
        fail(f"rank 0 wrote {w0} and rank 1 {w1}: rank 0 alone writes the "
             "scalars and the checkpoints")
    if outs[0]["train_flow"] != outs[1]["train_flow"]:
        faults.append(f"train_flow returned {outs[0]['train_flow']} and "
                      f"{outs[1]['train_flow']} on the two ranks")
    if faults:
        fail("; ".join(faults))
    return launches


# -- ops/scatter.py on the card ---------------------------------------------

# scatter_add_1d on the card: 2^22 values into 2^16 slots (runs of ~64),
# the run sums against float64 sums of the same f32 values.
SCATTER_CASE = (1 << 16, 1 << 22)
TOL_SCATTER = 1e-5                 # relative to the largest |f64 sum|


def phase_scatter(torch):
    """Phase 47: ops/scatter.py's scatter_add_1d on the card."""
    from motionpriorcmax_tpu_torch.ops import scatter_add_1d

    n, m = SCATTER_CASE
    rng = np.random.default_rng(47)
    idx = rng.integers(-8, n + 8, m)         # a few out of range, dropped
    vals = rng.normal(size=m).astype(np.float32)
    keep = (idx >= 0) & (idx < n)
    want = np.bincount(idx[keep], vals[keep].astype(np.float64), n)
    ti = torch.from_numpy(idx).cuda()
    tv = torch.from_numpy(vals).cuda()
    a, b = scatter_add_1d(n, ti, tv), scatter_add_1d(n, ti, tv)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        fail("[scatter] scatter_add_1d gave other bits in a second call")
    err = float(np.abs(a.cpu().numpy() - want).max()
                / max(1.0, np.abs(want).max()))
    if not err <= TOL_SCATTER:
        fail(f"[scatter] scatter_add_1d off its float64 sums by {err:.2e}")
    print(f"[scatter] scatter_add_1d on the card: {m} values into {n} "
          f"slots, the same bits in two calls, {err:.2e} of the largest "
          f"float64 sum")


def phase_knn_topk(torch):
    """Phase 48: the exact KNN's fused kernel (ops/cuda/knn_topk.py) at the
    flow-training and traj-train shapes on each of KNN_VARIANTS' databases,
    held to check_knn, and its time beside its operations bound and, on
    the loss's order, the plain version's, which is today's knn_blocked
    before the kernel (distance blocks, torch.topk)."""
    from motionpriorcmax_tpu_torch.ops import knn
    from motionpriorcmax_tpu_torch.ops.cuda import knn_topk as kt

    clock = sm_clock_hz()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for label, b, nb, h, w in KNN_PATHS:
        for variant, motion, shuffle in KNN_VARIANTS:
            queries, db = (torch.from_numpy(a).cuda() for a in knn_case(
                48, b, nb, h, w, motion=motion, shuffle=shuffle))
            g, n, _ = db.shape
            q = queries.shape[0]
            before = kt.knn_topk.launches
            idx, dist = knn.knn_blocked(queries, db, KNN_K)
            torch.cuda.synchronize()
            if kt.knn_topk.launches != before + 1:
                fail("[knn] knn_blocked did not launch the kernel once")
            try:
                ties, topk_lower = check_knn(queries, db, KNN_K, "l2", idx,
                                             dist)
            except AssertionError as err:
                fail(f"[knn] {label} {variant}: {err}")
            i2, d2 = kt.knn_topk(queries, db, KNN_K)
            if not (torch.equal(idx, i2) and torch.equal(dist, d2)):
                fail(f"[knn] {label} {variant}: two calls gave other bits")
            del idx, dist, i2, d2
            k_ms = timers(torch, lambda: kt.knn_topk(queries, db, KNN_K),
                          flush, reps=10)[0]
            line = (f"[knn] {label} {variant} (N(0, {motion:g}) px per unit "
                    f"time{', shuffled' if shuffle else ''}): G={g} Q={q} "
                    f"N={n} K={KNN_K}: kernel {k_ms:.2f} ms; {ties} rows "
                    f"tie at the K-th value, the lower indices taken, "
                    f"torch.topk's set the same in {topk_lower}; two calls "
                    "the same bits")
            if variant != "ordered":
                out[label][f"{variant}_ms"] = k_ms
                print(line)
            else:
                pairs = g * q * n
                bound = pairs * KNN_OPS_PER_PAIR / (132 * 128 * clock) * 1e3
                p_ms = timers(
                    torch, lambda: kt.knn_topk_plain(queries, db, KNN_K),
                    flush, reps=3, warmup=1)[0]
                print(f"{line}; {pairs:.3e} pairs, bound {bound:.2f} ms "
                      f"({KNN_OPS_PER_PAIR} f32 operations per pair at "
                      f"{clock / 1e9:.2f} GHz), plain = knn_blocked before "
                      f"the kernel {p_ms:.1f} ms")
                out[label] = {"ms": k_ms, "plain_ms": p_ms,
                              "library_ms": p_ms, "bound_ms": bound,
                              "bound_by": "operations", "tie_rows": ties,
                              "topk_lower_at_ties": topk_lower}
            del queries, db
            torch.cuda.empty_cache()
    return out


def flax_bn_calls(torch, x, dy, coef3, coef5, relu):
    """The timed calls of one norm's train-mode forward and backward:
    'kernels' the four launching calls alone (coefficients given),
    'norm' the whole Function (its C-length statistics included), 'plain'
    the four calls' plain versions on the card, 'library' F.batch_norm
    (cuDNN) + F.relu, forward and backward (never called by the port)."""
    import torch.nn.functional as F

    from motionpriorcmax_tpu_torch.ops.cuda import flax_batch_norm as fbn

    c = x.shape[1]
    weight = torch.ones(c, device="cuda", requires_grad=True)
    bias = torch.zeros(c, device="cuda", requires_grad=True)
    rm = torch.zeros(c, device="cuda")
    rv = torch.ones(c, device="cuda")
    xr = x.detach().clone().requires_grad_(True)

    def kernels():
        fbn.flax_bn_reduce(x)
        fbn.flax_bn_apply(x, coef3, relu)
        fbn.flax_bn_reduce(x, dy, coef3, relu)
        fbn.flax_bn_apply(x, coef5, relu, dy)

    def plain():
        fbn.reduce_plain(x)
        fbn.apply_plain(x, coef3, relu)
        fbn.reduce_plain(x, dy, coef3, relu)
        fbn.apply_plain(x, coef5, relu, dy)

    def norm():
        xr.grad = weight.grad = bias.grad = None
        fbn.flax_batch_norm(xr, weight, bias, rm, rv, True, 0.1, 1e-5, None,
                            relu).backward(dy)

    def library():
        xr.grad = weight.grad = bias.grad = None
        y = F.batch_norm(xr, rm, rv, weight, bias, True, 0.1, 1e-5)
        (F.relu(y) if relu else y).backward(dy)

    return {"kernels": kernels, "norm": norm, "plain": plain,
            "library": library}


def flax_bn_bytes(x):
    """(bound bytes, two-pass bytes) of one norm's forward and backward:
    x read and y written, then x and dy read and dx written, each once;
    and what the kernels' two passes each way move (the sums' reads
    besides)."""
    n = x.numel() * x.element_size()
    return 5 * n, 8 * n


def phase_flax_bn(torch):
    """Phase 49: the BatchNorm kernels at FLAX_BN_SHAPES, held to their
    plain versions (flax_bn_check), and one norm's train-mode forward and
    backward timed (CUDA events, L2 flushed; `card_ms`: the card's time
    alone) beside its byte bound, the plain versions and F.batch_norm +
    F.relu; the sums over the UNet's 18 norms of one step."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    out, unet = {}, {}
    for label, b, c, hw, dname, relu, count in FLAX_BN_SHAPES:
        dtype = getattr(torch, dname)
        x, dy, coef3, coef5 = flax_bn_inputs(torch, b, c, hw, dtype, c)
        try:
            err = flax_bn_check(torch, x, dy, coef3, coef5, relu)
        except AssertionError as e:
            fail(f"[flax-bn] {label}: {e}")
        calls = flax_bn_calls(torch, x, dy, coef3, coef5, relu)
        res = {"sums_rel_err": err}
        for name, fn in calls.items():
            fast = name in ("kernels", "norm")
            ms, card_ms, _ = timers(torch, fn, flush, reps=20 if fast else 5,
                                    warmup=3 if fast else 1)
            res[f"{name}_ms"] = ms
            if fast:
                res[f"{name}_card_ms"] = card_ms
        bound, two_pass = flax_bn_bytes(x)
        res["bound_ms"] = bound / H100_BYTES_PER_S * 1e3
        res["two_pass_ms"] = two_pass / H100_BYTES_PER_S * 1e3
        print(f"[flax-bn] {label}: B={b} C={c} {hw[0]}x{hw[1]} {dname}"
              f"{' + ReLU' if relu else ''} ({count} in the path), forward "
              f"+ backward: kernels {res['kernels_ms'] * 1e3:.1f} us (card "
              f"{res['kernels_card_ms'] * 1e3:.1f}), the whole norm "
              f"{res['norm_ms'] * 1e3:.1f} us (card "
              f"{res['norm_card_ms'] * 1e3:.1f}), bound "
              f"{res['bound_ms'] * 1e3:.1f} us (bytes, each once; the two "
              f"passes' {res['two_pass_ms'] * 1e3:.1f}), plain "
              f"{res['plain_ms'] * 1e3:.1f} us, F.batch_norm + relu "
              f"{res['library_ms'] * 1e3:.1f} us; sums {err:.2e} of their "
              f"scale, elementwise passes bit for bit, two calls the same "
              f"bits")
        out[label] = res
        if label.startswith("unet"):
            for k, v in res.items():
                if k.endswith("_ms"):
                    unet[k] = unet.get(k, 0.0) + count * v
        del x, dy, coef3, coef5, calls
        torch.cuda.empty_cache()
    if sum(s[-1] for s in FLAX_BN_SHAPES if s[0].startswith("unet")) \
            != UNET_NORMS:
        fail("FLAX_BN_SHAPES does not hold the UNet's 18 norms")
    print(f"[flax-bn] the UNet's {UNET_NORMS} norms of one B=14 step, forward "
          f"+ backward: kernels {unet['kernels_card_ms']:.2f} ms (card), "
          f"the whole norms {unet['norm_card_ms']:.2f} ms (card), bound "
          f"{unet['bound_ms']:.2f} ms (two passes "
          f"{unet['two_pass_ms']:.2f}), plain {unet['plain_ms']:.2f} ms, "
          f"F.batch_norm + relu {unet['library_ms']:.2f} ms")
    out["unet_step"] = unet
    return out

FLOW_SOURCES = {
    "iwe_vote_fwd": ("motionpriorcmax_tpu_torch/csrc/iwe_vote.cu",
                     "motionpriorcmax_tpu/ops/pallas/iwe_vote.py:398"),
    "iwe_vote_bwd": ("motionpriorcmax_tpu_torch/csrc/iwe_vote.cu",
                     "motionpriorcmax_tpu/ops/pallas/iwe_vote.py:197,411"),
    "lut_gather_fwd": ("motionpriorcmax_tpu_torch/csrc/lut_gather.cu",
                       "motionpriorcmax_tpu/ops/pallas/lut_gather.py:173"),
    "lut_segsum_bwd": ("motionpriorcmax_tpu_torch/csrc/lut_gather.cu",
                       "motionpriorcmax_tpu/ops/pallas/lut_gather.py:173"),
    "softmax_interp_fwd": (
        "motionpriorcmax_tpu_torch/csrc/softmax_interp.cu",
        "motionpriorcmax_tpu/ops/pallas/softmax_interp.py:276"),
    "softmax_interp_bwd": (
        "motionpriorcmax_tpu_torch/csrc/softmax_interp.cu",
        "motionpriorcmax_tpu/ops/pallas/softmax_interp.py:357"),
    "voxel_vote": ("motionpriorcmax_tpu_torch/csrc/voxel_vote.cu",
                   "motionpriorcmax_tpu/ops/pallas/voxel_vote.py:242"),
    "grid_segment_sum": ("motionpriorcmax_tpu_torch/csrc/segment_sum.cu",
                         "motionpriorcmax_tpu/ops/pallas/iwe_vote.py:481"),
}
FLOW_WORK = {
    "iwe_vote_fwd": "one polarity half: B=14, M=2^19, 480x640, cell-sorted "
                    "(unsorted_*: the same events in random order; "
                    "skewed_*: half the live events of each sample in one "
                    "16 x 64 region, 1% on one pixel, sorted again; wide_*: "
                    "the sorted events with a flow of up to 48 px; "
                    "*band_share: the live taps voted through the "
                    "shared-memory band; *card_ms: the card's time alone, "
                    "the host's enqueue covered by a spin)",
    "iwe_vote_bwd": "one polarity half: B=14, M=2^19, 480x640, cell-sorted "
                    "(row 3, JAX :411), no weight gradient, a contiguous "
                    "random cotangent (unsorted_*: the same events in "
                    "random order, row 4, JAX :197; skewed_* and wide_*: "
                    "as the forward's; unsorted_strided_*: the unsorted "
                    "events with the cotangent a select(1, 0) of a "
                    "[B, 2, H, W] tensor, as autograd hands it over; "
                    "*card_ms: the card's time alone, the host's enqueue "
                    "covered by a spin; deterministic: two calls gave the "
                    "same bits in all five cases)",
    "lut_gather_fwd": "B=14, M=2^20, LUT [1800, 160, 2] f32",
    "lut_segsum_bwd": "B=14, M=2^20, S=2 x 288,000 cells, C=2, the path's "
                      "cell-sorted batch (skewed_*: half the live events "
                      "of each sample in one 16 x 64 region, 1% on one "
                      "pixel, sorted again; traj_*: B=6, 2^19 live events "
                      "per sample in capacity 2^20, S=2 x 503,808 cells; "
                      "*card_ms: the card's time alone; deterministic: two "
                      "calls gave the same bits); replaces the boundary "
                      "gather of ops/events.py:459-464",
    "softmax_interp_fwd": "G=210, Q=N=19,200, C=2, per-bin band, 1% far "
                          "trajectories, f32 (library: "
                          "scaled_dot_product_attention, dense, no band; "
                          "bound over the needed pairs, those with a "
                          "nonzero weight; bound_scanned_ms: over every "
                          "scanned pair; *card_ms: the card's time alone; "
                          "traj_*: the traj-train softmax step's G=246, "
                          "Q=N=12,288, C=4, per-group dynamic band)",
    "softmax_interp_bwd": "G=210, Q=N=19,200, C=2, per-bin band, 1% far "
                          "trajectories, f32 d vals (bound and traj_* as "
                          "the forward's; deterministic: two calls gave "
                          "the same bits)",
    "voxel_vote": "B=14, M=2^20 cell-sorted events -> 14 x 15 x 480 x 640 "
                  "(unsorted_*: the same events in random order; skewed_*: "
                  "half the live events of each sample in one 16 x 64 "
                  "region, 1% on one pixel; *card_ms: the card's time "
                  "alone, the host's enqueue covered by a spin)",
    "grid_segment_sum": "B=14, M=2^20 unsorted events (padding skipped), "
                        "LUT [1800, 160, 2] f32 (library: torch.gather's "
                        "backward, scatter_add_; skewed_*: half the live "
                        "events of each sample in one 16 x 64 region, 1% "
                        "on one pixel, time order; traj_*: [6, 3936, 128, "
                        "2], 2^19 events per sample; *card_ms: the card's "
                        "time alone)",
}


def main() -> int:
    import torch

    t_start = time.perf_counter()
    name, count, smi_line = phase_env(torch)
    phase_build()

    # traj-val
    max_err, totals = phase_kernel(torch)

    from motionpriorcmax_tpu_torch.models.raft_spline import RAFTSplineConfig
    from motionpriorcmax_tpu_torch.training.raft_spline import \
        create_raft_model

    cfg = RAFTSplineConfig()   # Tab2L5: 41/25 bins, degree 10, 12 iterations
    model = create_raft_model(cfg, "cuda", torch.Generator().manual_seed(0))
    ts = tuple(np.linspace(0, 1, 7)[1:].tolist())
    requests = [synthetic_request(torch, cfg, 1000 + i) for i in range(4)]
    launches = phase_serving(torch, model, requests, ts)
    del model, requests
    torch.cuda.empty_cache()
    phase_card_vs_cpu(torch)
    print(f"[done] traj-val phases {time.perf_counter() - t_start:.1f} s")
    kernels = [{
        "name": "corr_window_lookup", "route": "cuda",
        "source": "motionpriorcmax_tpu_torch/csrc/corr_window.cu",
        "replaces": "motionpriorcmax_tpu/ops/pallas/corr_window.py:101",
        "launches": launches, "max_abs_err": max_err,
        "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"], "bound_by": "bytes",
        "library_ms": totals["library_ms"],
        "card_ms": totals["card_ms"],
        "levels_one_by_one_ms": totals["level_ms"],
        "levels_one_by_one_card_ms": totals["level_card_ms"],
        "staging": "cp.async",
        "work": "one refinement iteration: levels 1-4 in one launch, B=8, "
                "384x512, f32 (library: F.grid_sample per level, summed; "
                "*card_ms: the card's time alone, the host's enqueue "
                "covered by a spin)",
    }]

    # flow-train, exact KNN and host voxel grids
    t_flow = time.perf_counter()
    fcfg, floss = flow_configs(DSEC_CONFIG)
    (train_batch, val_batch, unsorted_train, unsorted_val,
     windows) = phase_flow_batch(fcfg, floss,
                                 DSEC_CONFIG["data"]["batch_size"])
    numbers = phase_flow_kernels(torch, fcfg, floss, train_batch)
    flow_launches, exact_ms = phase_flow_train(
        torch, fcfg, floss, train_batch, val_batch, smi_line, EXACT_STEP,
        EXACT_VAL)
    torch.cuda.empty_cache()
    phase_flow_card_vs_cpu(torch)
    print(f"[done] flow-train phases {time.perf_counter() - t_flow:.1f} s")

    # flow-train, knn_method softmax and voxel grids built in the step:
    # phase 8's batches without their 'voxel'
    t_soft = time.perf_counter()
    scfg, sloss = flow_configs({**DSEC_CONFIG, "loss": {
        **DSEC_CONFIG["loss"], "knn_method": "softmax"}})
    host_voxel = train_batch.pop("voxel"), val_batch.pop("voxel")
    numbers.update(phase_softmax_kernels(torch, sloss, train_batch))
    soft_launches, soft_ms = phase_flow_train(
        torch, scfg, sloss, train_batch, val_batch, smi_line, SOFTMAX_STEP,
        SOFTMAX_VAL, tag="softmax-train", want_losses=SOFTMAX_STEP_LOSSES,
        n_steps=len(SOFTMAX_STEP_LOSSES))
    torch.cuda.empty_cache()
    phase_flow_card_vs_cpu(torch, {"knn_method": "softmax"}, True,
                           SOFTMAX_STEP, tag="softmax-card-vs-cpu")
    print(f"[done] softmax flow-train phases "
          f"{time.perf_counter() - t_soft:.1f} s")

    # traj-train: RAFT-Spline training, the Tab2L5 experiment
    t_traj = time.perf_counter()
    bwd_err32, bwd_err16 = phase_bwd_kernel(torch)
    bwd_totals = phase_bwd_timing(torch)
    selfsup, supervised, val_samples = phase_traj_batches()
    traj_launches = phase_traj_train(torch, TAB2L5_CONFIG, selfsup,
                                     val_samples, smi_line, TRAJ_STEP,
                                     "traj-train")
    torch.cuda.empty_cache()
    phase_traj_train(torch, {**TAB2L5_CONFIG, "loss": {
        **TAB2L5_CONFIG["loss"], "knn_method": "softmax"}}, selfsup,
        val_samples, smi_line, TRAJ_SOFTMAX_STEP, "traj-train-softmax",
        want_losses=TRAJ_SOFTMAX_STEP_LOSSES)
    torch.cuda.empty_cache()
    phase_traj_train(torch, TAB2L5_CONFIG, supervised, val_samples, smi_line,
                     TRAJ_SUPERVISED_STEP, "traj-train-supervised",
                     supervised=True)
    del supervised
    torch.cuda.empty_cache()
    phase_traj_card_vs_cpu(torch)
    print(f"[done] traj-train phases {time.perf_counter() - t_traj:.1f} s")

    # flow-train on unsorted events (softmax, device voxel): row 5
    t_uns = time.perf_counter()
    numbers["grid_segment_sum"] = phase_segment_sum(torch, sloss,
                                                    unsorted_train)
    uns_launches, uns_ms = phase_unsorted_train(
        torch, scfg, sloss, unsorted_train, unsorted_val, smi_line, soft_ms)
    del unsorted_val
    torch.cuda.empty_cache()
    phase_flow_card_vs_cpu(torch, {"knn_method": "softmax"}, True,
                           UNSORTED_STEP, tag="unsorted-card-vs-cpu",
                           cell_sort=False)
    phase_learning(torch)
    print(f"[done] unsorted flow-train phases "
          f"{time.perf_counter() - t_uns:.1f} s")
    t_host = time.perf_counter()
    phase_host_data(torch, fcfg, floss, {
        (True, False): (exact_ms, "exact-KNN host-voxel (phase 11)"),
        (False, False): (exact_ms, "exact-KNN host-voxel (phase 11, sorted)"),
        (True, True): (soft_ms, "softmax device-voxel (phase 16)"),
        (False, True): (uns_ms, "unsorted softmax device-voxel (phase 27)")})
    print(f"[done] host data phase {time.perf_counter() - t_host:.1f} s")

    # dsec-infer: DSEC benchmark inference, row 8 at B = 1
    t_inf = time.perf_counter()
    infer_cases = phase_infer_vote(torch)
    print(f"[done] phase 32 {time.perf_counter() - t_inf:.1f} s")
    infer_launches, infer_numbers = phase_infer(torch, smi_line)
    print(f"[done] phases 32-33 {time.perf_counter() - t_inf:.1f} s")
    infer_cpu_err = phase_infer_card_vs_cpu(torch)
    print(f"[done] dsec-infer phases {time.perf_counter() - t_inf:.1f} s")

    # flow-train's grid KNN, L1 softmax and capacity buckets
    t_b = time.perf_counter()
    gcfg, gloss = flow_configs({**DSEC_CONFIG, "loss": {
        **DSEC_CONFIG["loss"], "knn_method": "grid"}})
    phase_flow_train(
        torch, gcfg, gloss, {**train_batch, "voxel": host_voxel[0]},
        {**val_batch, "voxel": host_voxel[1]}, smi_line, GRID_STEP,
        GRID_VAL, tag="grid-train", n_steps=PART_B_STEPS)
    torch.cuda.empty_cache()
    phase_flow_card_vs_cpu(torch, {"knn_method": "grid"}, want=GRID_STEP,
                           tag="grid-card-vs-cpu")
    print(f"[done] phase 35 {time.perf_counter() - t_b:.1f} s")
    lcfg, lloss = flow_configs({**DSEC_CONFIG, "loss": {
        **DSEC_CONFIG["loss"], "knn_method": "softmax", "dist_norm": "l1"}})
    phase_flow_train(torch, lcfg, lloss, train_batch, val_batch, smi_line,
                     L1_STEP, L1_VAL, tag="l1-softmax-train",
                     n_steps=PART_B_STEPS)
    torch.cuda.empty_cache()
    phase_flow_card_vs_cpu(torch, {"knn_method": "softmax",
                                   "dist_norm": "l1"}, True, L1_STEP,
                           tag="l1-card-vs-cpu")
    print(f"[done] phases 35-36 {time.perf_counter() - t_b:.1f} s")
    phase_buckets(torch, scfg, sloss, smi_line)
    torch.cuda.empty_cache()
    print(f"[done] grid / L1 softmax / bucket phases "
          f"{time.perf_counter() - t_b:.1f} s")

    # flow-train's epoch image panels: phase 8's windows with GT flow
    t_p = time.perf_counter()
    render_launches, render_ms = phase_panels(
        torch, fcfg, floss, windows, {**train_batch, "voxel": host_voxel[0]},
        {**val_batch, "voxel": host_voxel[1]}, smi_line, RENDER_EXACT,
        "panel")
    torch.cuda.empty_cache()
    soft_render_launches, soft_render_ms = phase_panels(
        torch, scfg, sloss, [{k: v for k, v in smp.items() if k != "voxel"}
                             for smp in windows],
        train_batch, val_batch, smi_line, RENDER_SOFTMAX, "panel-softmax")
    del windows
    torch.cuda.empty_cache()
    render_cpu_err = phase_panels_card_vs_cpu(torch)
    print(f"[done] image panel phases {time.perf_counter() - t_p:.1f} s")

    # RAFT-Spline with compute_dtype and corr_dtype bfloat16
    from motionpriorcmax_tpu_torch.cli.main import traj_train_configs
    from motionpriorcmax_tpu_torch.training.raft_spline import \
        raft_validation_step

    t_16 = time.perf_counter()
    cfg16 = RAFTSplineConfig(**BF16_RAFT)
    model = create_raft_model(cfg16, "cuda", torch.Generator().manual_seed(0))
    requests = [synthetic_request(torch, cfg16, 1000 + i) for i in range(4)]
    bf16_launches = phase_serving(torch, model, requests, ts,
                                  tag="serving-bf16")
    # The lookup's inputs of one more request, not timed.
    store = {}
    with first_lookup(torch, store):
        raft_validation_step(model, {k: v.cuda() for k, v in
                                     requests[1].items()}, ts)
    del model, requests
    bf16_lookup = phase_bf16_lookup(torch, store["levels"], store["c_total"],
                                    "bf16-kernel-vs-plain")
    del store
    torch.cuda.empty_cache()
    tree16 = {**TAB2L5_CONFIG, "model": {**TAB2L5_CONFIG["model"],
                                         **BF16_RAFT}}
    traj16_launches = phase_traj_train(
        torch, tree16, selfsup, val_samples, smi_line,
        {**TRAJ_STEP, **bn_launches(RAFT_NORMS, True)}, "traj-train-bf16")
    del val_samples
    torch.cuda.empty_cache()
    # A train-mode forward of the step's model on its batch, not timed: the
    # pyramid the backward kernel sees at B=6.
    model = create_raft_model(
        traj_train_configs(tree16, (H, W), TRAJ_SCHEDULE_STEPS)[0], "cuda",
        torch.Generator().manual_seed(0)).train()
    store = {}
    with first_lookup(torch, store), torch.no_grad():
        model(torch.from_numpy(selfsup["ev_repr"]).cuda())
    del model
    bf16_bwd = phase_bf16_bwd(torch, store["levels"], store["c_total"],
                              "bf16-bwd-kernel-vs-plain")
    del store
    torch.cuda.empty_cache()
    bf16_cpu_err = phase_bf16_card_vs_cpu(torch)
    print(f"[done] bf16 RAFT-Spline phases {time.perf_counter() - t_16:.1f} s")

    # Multi-process training: a world of one over NCCL (phase 43), then two
    # ranks on the card over gloo (phases 44-46)
    t_par = time.perf_counter()
    nccl_launches = phase_nccl_world(
        torch, fcfg, floss, {**train_batch, "voxel": host_voxel[0]},
        {**val_batch, "voxel": host_voxel[1]}, smi_line, exact_ms)
    del val_batch, host_voxel
    torch.cuda.empty_cache()
    par_launches = phase_parallel(torch, scfg, sloss, train_batch,
                                  unsorted_train, selfsup, smi_line)
    del train_batch, unsorted_train, selfsup
    print(f"[done] multi-process phases {time.perf_counter() - t_par:.1f} s")

    # ops/scatter.py (phase 47)
    torch.cuda.empty_cache()
    phase_scatter(torch)
    # The exact KNN's fused kernel (phase 48)
    torch.cuda.empty_cache()
    knn_numbers = phase_knn_topk(torch)
    # The BatchNorm kernels (phase 49)
    torch.cuda.empty_cache()
    bn_numbers = phase_flax_bn(torch)
    # Row 1 in the bf16 requests (phase 40): launches per request (the warm-up
    # included) and the kernel on their bf16 pyramid.
    kernels[0]["bf16_compute"] = {"request_launches": bf16_launches / 4,
                                  "card_vs_cpu_rel_err": bf16_cpu_err,
                                  **bf16_lookup}
    kernels.append({
        "name": "corr_window_lookup_bwd", "route": "cuda",
        "source": "motionpriorcmax_tpu_torch/csrc/corr_window.cu",
        "replaces": "motionpriorcmax_tpu/ops/pallas/corr_window.py:155",
        "launches": traj_launches["corr_window_lookup_bwd"],
        "max_abs_err": bwd_err32, "bf16_max_abs_err": bwd_err16,
        "bf16_compute": {"step_launches": traj16_launches[
            "corr_window_lookup_bwd"] / TRAIN_STEPS, **bf16_bwd},
        "ms": bwd_totals["ms"], "plain_ms": bwd_totals["plain_ms"],
        "bound_ms": bwd_totals["bound_ms"], "bound_by": "bytes",
        "library_ms": bwd_totals["library_ms"],
        "work": "one refinement iteration's backward: levels 1-4, B=6, "
                "384x512, f32 volume (library: F.grid_sample's backward, "
                "d input and d grid)",
    })
    for kname in FLOW_KERNELS + SOFTMAX_KERNELS + ("grid_segment_sum",):
        source, replaces = FLOW_SOURCES[kname]
        runs = (uns_launches if kname == "grid_segment_sum" else
                soft_launches if kname in SOFTMAX_KERNELS else flow_launches)
        entry = {"name": kname, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": runs[kname]}
        if kname in ("iwe_vote_fwd", "iwe_vote_bwd"):
            # Row 4: the same kernel on the unsorted step's events.
            entry["unsorted_step_launches"] = uns_launches[kname]
        entry.update(numbers[kname])
        entry["work"] = FLOW_WORK[kname]
        if soft_render_launches.get(kname):
            # The image panel's render of one sample (phase 38).
            entry["panel_render_launches"] = {
                "exact_host_voxel": render_launches.get(kname, 0),
                "softmax_device_voxel": soft_render_launches[kname],
                "render_ms": [render_ms, soft_render_ms],
                "card_vs_cpu_rel_err": render_cpu_err}
        if kname == "voxel_vote":
            # This slice's main path: dsec-infer, one launch per window.
            entry["inference"] = {
                "launches": infer_launches,
                "launches_per_window": infer_launches / INFER_WINDOWS,
                "cases": infer_cases,
                "card_vs_cpu_rel_err": infer_cpu_err,
                "work": "B=1, N events per window (0, 1, 4097, 2^20, 3M), "
                        "fractional rectified coordinates, 4% on the last "
                        "row / column, 15 x 480 x 640 (bound: 24 N + "
                        "4 x 15 x 480 x 640 bytes at 3.35 TB/s; library: "
                        "index_add_ of the eight taps)",
                **infer_numbers}
        kernels.append(entry)

    kernels.append({
        "name": "knn_topk", "route": "cuda",
        "source": "motionpriorcmax_tpu_torch/csrc/knn_topk.cu",
        "replaces": "none: the JAX package's KNN is XLA's lax.top_k",
        "launches": flow_launches["knn_topk"],
        "traj_train_launches": traj_launches["knn_topk"],
        "panel_render_launches": render_launches.get("knn_topk", 0),
        **knn_numbers["flow"], "traj": knn_numbers["traj"],
        "work": "the flow-training step's exact KNN: G=210, Q=N=19,200, "
                "K=32, l2 (traj: the traj-train step's G=246, Q=N=12,288; "
                "*_ms by database: the loss's order, shuffled, a flow ten "
                "times as large; bound: 5 f32 operations per pair at the "
                "maximum SM clock; plain and library: knn_blocked before "
                "the kernel, distance blocks and torch.topk)"})
    kernels.append({
        "name": "flax_batch_norm", "route": "cuda",
        "source": "motionpriorcmax_tpu_torch/csrc/flax_batch_norm.cu",
        "replaces": "none: the JAX package leaves the norm to XLA's fusion",
        "launches": {k: flow_launches[k] for k in bn_launches(0, True)},
        "traj_train_launches": {k: traj_launches[k]
                                for k in bn_launches(0, True)},
        "panel_render_launches": render_launches.get("flax_bn_apply", 0),
        **bn_numbers["unet_step"],
        "shapes": {k: v for k, v in bn_numbers.items() if k != "unet_step"},
        "work": "one train-mode forward and backward of the UNet's 18 norms "
                "+ ReLU at B=14, 480x640, bf16 (shapes: each shape of the "
                "UNet's and of RAFT-Spline's context encoder at B=6, f32, "
                "once; kernels: the four launching calls, norm: the whole "
                "Function; bound: x, y, dy, dx each once at 3.35 TB/s, "
                "two_pass: the kernels' passes; library: F.batch_norm + "
                "F.relu, cuDNN)"})

    for entry in kernels:
        # Phases 43-45: launches per step of each rank on the sharded paths
        # (the world of one: over its whole train_flow run).
        kname = entry["name"]
        entry["sharded_launches"] = {
            case: [per_rank.get(kname, 0) for per_rank in ranks]
            for case, ranks in par_launches.items()
            if any(per_rank.get(kname, 0) for per_rank in ranks)}
        if nccl_launches.get(kname):
            entry["sharded_launches"]["nccl_world1_run"] = \
                nccl_launches[kname]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--rank":
        # One rank of phases 44-46, started by phase_parallel.
        sys.exit(rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())

"""The inputs, oracles and timer that the card tools and the card tests
share: `chip_smoke.py` (the smoke run of the port on one card),
`kernel_ab.py` (kernels of two or more checkouts timed in one call) and
tests/test_torch_*.py import them from here, and this module imports
neither script, nothing of JAX and nothing of perfbench/.  NumPy is
imported here; torch and motionpriorcmax_tpu_torch only inside the
functions that use them, so the module imports without a card, and each
of kernel_ab.py's runs gets the package of the checkout it imports.

  * DSEC_CONFIG, TAB2L5_CONFIG, DSEC_INFERENCE_CONFIG: configurations as
    dicts (the card's machine has no yaml); CPU tests hold each equal to
    its YAML file;
  * the kernels' inputs from seeds, at the paths' shapes: level_inputs,
    vote_batch, vote_cases, segsum_cases, segment_sum_cases,
    softmax_cases, knn_case, flax_bn_inputs (FLAX_BN_SHAPES, KNN_*); one
    seed gives the same arrays in every tool, so the losses and bounds
    recorded against them hold;
  * the oracles check_knn and flax_bn_check, and the TOL_* bounds of the
    kernels against their plain versions;
  * infer_part_marks: the parts of a dsec-infer window (INFER_PARTS);
  * timers, the one kernel timer, and nvidia_smi_line, the card's name
    and power limit.

Run the tools from the repository root, and pytest with `python -m
pytest` there: the module is found on that path.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import statistics
import subprocess
import time

import numpy as np


# ~1 ms of card cycles, longer than any timed call's host-side enqueue
# (timers' card_ms).
HOST_COVER_CYCLES = 2_000_000
RADIUS = 4
K = (2 * RADIUS + 1) ** 2
BATCH, H, W = 8, 384, 512
Q = (H // 8) * (W // 8)
# (targets, h2, w2) per pyramid level of Tab2L5: levels (1, 1, 1, 1, 4).
LEVELS = [(5, 48, 64), (1, 24, 32), (1, 12, 16), (1, 6, 8)]


def nvidia_smi_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


REPS = 20


def timers(torch, fn, flush, reps=REPS, warmup=3):
    """(ms, card_ms, host_us) of fn(): `warmup` calls and a synchronize,
    then two rounds of `reps` calls, the L2 flushed (flush.zero_()) before
    each call, each timed between two CUDA events recorded around it; the
    medians of:
      ms       the first round: when the host takes longer to enqueue the
               call than the card takes to flush, the host's launch
               overhead is in it (the port's yardstick: every `ms` of
               chip_smoke.py's kernels line and of kernel_ab.py);
      card_ms  the second round, a spin of the card (torch.cuda._sleep)
               between the flush and the start event covering the host's
               enqueue: the card's time alone;
      host_us  the wall time of the Python call itself in the first
               round, without a synchronize (what the host spends to
               enqueue it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for spin in (False, True):
        times, host = [], []
        for _ in range(reps):
            flush.zero_()
            if spin:
                torch.cuda._sleep(HOST_COVER_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fn()
            host.append(time.perf_counter() - t0)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out.append((statistics.median(times), statistics.median(host) * 1e6))
    (ms, host_us), (card_ms, _) = out
    return ms, card_ms, host_us


def level_inputs(torch, t, h2, w2, lvl, seed, dtype, batch=BATCH):
    """A level volume and window centres like the path's: the query pixel
    scaled to the level plus a flow-like offset, with 5% of the centres far
    outside or just outside the map."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    corr = torch.randn(t, batch, Q, h2, w2, device=dev, generator=g).to(dtype)
    qy = (torch.arange(Q, device=dev) // (W // 8)).float()
    qx = (torch.arange(Q, device=dev) % (W // 8)).float()
    scale = 2.0 ** lvl
    cx = (qx / scale + 3 * torch.randn(t, batch, Q, device=dev, generator=g))
    cy = (qy / scale + 3 * torch.randn(t, batch, Q, device=dev, generator=g))
    far = torch.rand(t, batch, Q, device=dev, generator=g) < 0.05
    cx = torch.where(far, torch.full_like(cx, -1e6), cx)
    cy = torch.where(far & (qx > 32), torch.full_like(cy, h2 + 0.5), cy)
    return corr.contiguous(), cx.contiguous(), cy.contiguous()


# ---------------------------------------------------------------------------
# flow-train (dsec.yaml): the focus loss's kernels
# ---------------------------------------------------------------------------

# config/flow_training/dsec.yaml as a dict: the GPU machine has no yaml
# (tests/test_torch_flow_train.py checks that the two agree).
DSEC_CONFIG = {
    "common": {"height": 480, "width": 640, "num_bins": 15,
               "polarity_aware_batching": True, "patch_size": 4},
    "model": {"lr": 0.0001, "model_type": "default", "num_basis": 1,
              "basis_type": "polynomial", "compute_dtype": "bfloat16"},
    "loss": {"loss_name": "FOCUS", "num_tref": 1, "num_knn": 32,
             "smooth_weight": 0.003, "lut_superpixel_size": 4,
             "focus_loss_norm": "l1", "dist_norm": "l2",
             "scale_iwe_by_dt": True, "mask_image_border": True,
             "interpolation_scheme": "mean",
             "smooth_type": "on_flow_to_tref"},
    "data": {"dataset": "DSEC", "data_path": "data/dsec/train",
             "num_workers": 16, "batch_size": 14, "norm_type": "mean_std",
             "quantile": 0},
    "trainer": {"max_epochs": 100},
}
FLOW_CAPACITY = 1 << 20            # the CLI's --event-capacity default
FLOW_EVENTS = 1_000_000            # events per synthetic 100 ms window
# Kernel vs plain on the card: the vote adds a pixel's votes with atomics
# in run-dependent order (a few ulps of the pixel's sum); its backward and
# the segment sum use the same f32 sums as their plain versions up to
# fused multiply-adds and summation order; the gather is a selection.
TOL_VOTE_FWD = 1e-5                # relative to the image's largest value
TOL_VOTE_BWD = 1e-5                # relative to the largest cotangent
TOL_SEGSUM = 1e-5                  # relative to the largest cell sum
# Rows 7 and 8: the interpolation sums its weights in another order than
# the plain version's matrix product, with fused multiply-adds; the voxel
# vote adds a voxel's votes in a run-dependent order (its records reach
# the voxel's owner thread in the order integer atomics gave them).
TOL_SOFTMAX = 1e-5                 # relative to the largest plain value
TOL_VOXEL = 1e-5                   # relative to the grid's largest value


def flow_configs(tree, **model_overrides):
    from motionpriorcmax_tpu_torch.cli.main import flow_configs as build
    from motionpriorcmax_tpu_torch.config import propagate_config

    tree = propagate_config(copy.deepcopy(tree))
    tree["model"].update(model_overrides)
    return build(tree)


def flow_samples(seed, n_samples, n_events, h, w, nb, gt=False, voxel=True):
    """DSEC-like samples from a numpy seed: rectified (float) pixel
    coordinates, sorted normalized times, random polarity, host voxel
    grids (unless not `voxel`); with `gt` a GT flow and validity mask."""
    from motionpriorcmax_tpu_torch.data.host_ops import voxelize_normalized_host

    rng = np.random.default_rng(seed)
    edges = np.linspace(0, 1, nb + 1)
    samples = []
    for _ in range(n_samples):
        t = np.sort(rng.random(n_events))
        ev = np.stack([rng.random(n_events) * (h - 1),
                       rng.random(n_events) * (w - 1), t,
                       rng.integers(0, 2, n_events),
                       np.clip(np.searchsorted(edges, t) - 1, 0, None)],
                      -1).astype(np.float32)
        s = {"pos_events": ev[ev[:, 3] == 1], "neg_events": ev[ev[:, 3] == 0]}
        if voxel:
            s["voxel"] = voxelize_normalized_host(ev, nb, h, w)
        if gt:
            s["forward_flow"] = (3 * rng.standard_normal((2, h, w))
                                 ).astype(np.float32)
            s["flow_valid"] = rng.random((h, w)) < 0.7
        samples.append(s)
    return samples


def vote_inputs(torch, events, npos, seed, flow_scale=1.0):
    """Warped coordinates and weights of one polarity half, the layout
    make_iwes votes: (y, x) plus a smooth flow of up to 8 x flow_scale
    px, 5% of them far outside."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    y, x = events[..., 0], events[..., 1]
    coords = torch.stack([y + 8 * flow_scale * torch.sin(x / 50),
                          x + 6 * flow_scale * torch.cos(y / 40)], dim=-1)
    far = torch.rand(coords.shape[:2], device="cuda", generator=g) < 0.05
    sign = torch.where(torch.rand(coords.shape[:2], device="cuda",
                                  generator=g) < 0.5, -1.0, 1.0)
    coords = torch.where(far[..., None], (sign * 1e9)[..., None], coords)
    weight = events[..., 5] * (1 - (events[..., 2] - 0.5).abs())
    return coords[:, :npos], weight[:, :npos]       # batch-strided views


def vote_batch(seed=7, cell_sort=True):
    """Phase 8's host batch without its voxel grids (the inputs of
    kernel_ab.py): 14 samples of FLOW_EVENTS events at dsec.yaml's
    shapes, collated with the loader's LUT-cell sort or, without
    `cell_sort`, in time order as the unsorted path collates them."""
    from motionpriorcmax_tpu_torch.data.collate import collate_fixed_capacity

    cfg, loss_cfg = flow_configs(DSEC_CONFIG)
    h, w = cfg.image_shape
    samples = flow_samples(seed, DSEC_CONFIG["data"]["batch_size"],
                           FLOW_EVENTS, h, w, cfg.num_bins, gt=True,
                           voxel=False)
    params = (loss_cfg.image_shape, loss_cfg.num_bins,
              loss_cfg.lut_superpixel_size) if cell_sort else None
    return collate_fixed_capacity(samples, FLOW_CAPACITY, polarity_aware=True,
                                  lut_cell_sort_params=params), loss_cfg


def vote_cases(torch, batch, h, w, nb, superpixel):
    """The IWE vote's inputs at the path's shapes, one polarity half of
    the batch (B x num_pos_events), as {label: (coords, weight)}:
      sorted    the half as the path votes it, cell-sorted (row 3)
      unsorted  the same events in random order (row 4)
      skewed    per sample half the live events in one 16 x 64 region
                and 1% on one pixel, then sorted again by the loader's
                LUT-cell sort (a hot pixel's events adjacent)
      wide      the sorted half with its flow x 6 (up to 48 px): chunks
                whose taps span more rows than the band holds."""
    from motionpriorcmax_tpu_torch.data.host_ops import lut_cell_sort

    npos = batch["num_pos_events"]
    events = torch.from_numpy(batch["events"]).cuda()
    b = events.shape[0]
    coords, weight = vote_inputs(torch, events, npos, 11)
    g = torch.Generator(device="cuda").manual_seed(13)
    perm = torch.argsort(torch.rand(b, npos, device="cuda", generator=g), 1)
    skew = skewed_events(batch["events"], h, w, 12)
    for i in range(b):
        skew[i] = lut_cell_sort(skew[i], (h, w), nb, superpixel,
                                num_pos_events=npos)[0]
    return {
        "sorted": (coords, weight),
        "unsorted": (torch.gather(coords, 1, perm[..., None].expand(-1, -1, 2)),
                     torch.gather(weight, 1, perm)),
        "skewed": vote_inputs(torch, torch.from_numpy(skew).cuda(), npos, 11),
        "wide": vote_inputs(torch, events, npos, 11, flow_scale=6.0),
    }


def vote_band_share(iv, coords, weight, h, w):
    """Share of the live taps that the forward kernel's partition (its
    plain twin) votes through the shared-memory band."""
    _, n_band, n_direct = iv.iwe_vote_banded_plain(coords, weight, h, w)
    return n_band / max(1, n_band + n_direct)


def skewed_events(events, h, w, seed):
    """The batch's events [B, M, 6] (numpy) with, per sample, half the live
    events moved into one 16 x 64-pixel region and 1% onto one pixel."""
    rng = np.random.default_rng(seed)
    ev = events.copy()
    for i in range(ev.shape[0]):
        live = np.flatnonzero(ev[i, :, 5] > 0)
        moved = rng.permutation(live)[:live.size // 2]
        y0 = rng.integers(0, h - 16)
        x0 = rng.integers(0, w - 64)
        ev[i, moved, 0] = rng.uniform(y0, y0 + 16, moved.size)
        ev[i, moved, 1] = rng.uniform(x0, x0 + 64, moved.size)
        hot = moved[:live.size // 100]
        ev[i, hot, 0] = y0 + 7.5
        ev[i, hot, 1] = x0 + 31.25
    return ev


def sorted_segsum_case(torch, b, half, live, cells, seed):
    """Cotangents [B, 2 * half, 2] and cell_ends [B, 2 * cells] of a
    polarity-packed, cell-sorted batch made on the card in the loader's
    layout (data/host_ops.py::lut_cell_sort): per half, `live` events on
    uniform random cells, and half - live padding rows in cell 0 after
    that cell's live events, with zero cotangent."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(b, 2 * half, 2, device=dev, generator=gen)
    pos = torch.arange(half, device=dev)[None]
    ends = []
    for s in range(2):
        keys = torch.randint(0, cells, (b, live), device=dev, generator=gen)
        counts = torch.zeros(b, cells, dtype=torch.long, device=dev)
        counts.scatter_add_(1, keys, torch.ones_like(keys))
        first = counts[:, :1].clone()
        counts[:, 0] += half - live
        ends.append(s * half + torch.cumsum(counts, 1))
        pad = (pos >= first) & (pos < first + half - live)
        g[:, s * half:(s + 1) * half][pad] = 0.0
    return g, torch.cat(ends, 1).int()


def segsum_cases(torch, batch, loss_cfg):
    """Row 6's inputs, {label: (g [B, M, 2], cell_ends, cells)}:
      sorted  phase 8's cell-sorted batch, normal cotangents, zero on the
              padding rows (their vote weight is 0): the path's; the
              padding forms the long run of cell 0 of each half (~24k)
      skewed  the same samples through skewed_events, sorted again by the
              loader's LUT-cell sort: runs of hundreds of events
      traj    the traj-train shape: B=6, 2^19 live events per sample in
              capacity 2^20, LUT [3936, 128]: 2^18 padding rows per half
              (sorted_segsum_case)"""
    from motionpriorcmax_tpu_torch.data.host_ops import lut_cell_sort

    h, w = loss_cfg.image_shape
    nb, sp = loss_cfg.num_bins, loss_cfg.lut_superpixel_size
    cells = nb * (h // sp) * (w // sp)
    npos = batch["num_pos_events"]
    gen = torch.Generator(device="cuda").manual_seed(21)

    def cotangents(ev):
        valid = torch.from_numpy(ev[..., 5]).cuda()
        return (torch.randn(*valid.shape, 2, device="cuda", generator=gen)
                * valid[..., None])

    skew = skewed_events(batch["events"], h, w, 12)
    skew_ends = np.empty_like(batch["lut_cell_ends"])
    for i in range(len(skew)):
        skew[i], skew_ends[i] = lut_cell_sort(skew[i], (h, w), nb, sp,
                                              num_pos_events=npos)
    tr, tx = TRAJ_LUT
    traj = sorted_segsum_case(torch, TRAIN_BATCH, TRAIN_CAPACITY // 2,
                              TRAIN_EVENTS // 2, tr * tx, 22)
    return {
        "sorted": (cotangents(batch["events"]),
                   torch.from_numpy(batch["lut_cell_ends"]).cuda(), cells),
        "skewed": (cotangents(skew), torch.from_numpy(skew_ends).cuda(),
                   cells),
        "traj": (*traj, tr * tx),
    }


def softmax_inputs(torch, loss_cfg, b, seed, far=0.01):
    """The interpolation's operands at a step's shapes: the LUT grid as
    queries; db = linear trajectories (flow up to 60 px at t = 1, a share
    `far` of them far outside the image) at the bin midtimes; values =
    their flow to t_ref = 0.37 (and to the next bin, as the step adds with
    smooth_type on_flow_to_next); the band the step computes (per bin
    unless the config asks for a dynamic one)."""
    from motionpriorcmax_tpu_torch.losses.focus import (interp_band,
                                                        lut_grid_points)

    loss_cfg = dataclasses.replace(loss_cfg, interp_band_per_bin=True)
    h, w = loss_cfg.image_shape
    s, nb = loss_cfg.lut_superpixel_size, loss_cfg.num_bins
    wq = w // s
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    grid = torch.from_numpy(lut_grid_points(loss_cfg)).to(dev)      # [N, 2]
    n = grid.shape[0]
    flow = (torch.rand(b, n, 2, device=dev, generator=g) * 2 - 1) * 60.0
    away = torch.rand(b, n, device=dev, generator=g) < far
    # Far trajectories: >= 3,000 px out of the image even at bin 0.
    flow = torch.where(away[..., None], torch.full_like(flow, 1e5), flow)
    t_mid = (torch.arange(nb, device=dev, dtype=torch.float32) + 0.5) / nb
    db = grid[None, None] + flow[:, None] * t_mid[None, :, None, None]
    vals = flow[:, None] * (0.37 - t_mid)[None, :, None, None]
    if (loss_cfg.smooth_weight > 0
            and loss_cfg.smooth_type == "on_flow_to_next"):
        to_next = (flow[:, None] / nb).expand(-1, nb, -1, -1).clone()
        to_next[:, -1] = 0.0
        vals = torch.cat([vals, to_next], dim=-1)
    db = db.reshape(b * nb, n, 2).contiguous()
    vals = vals.reshape(b * nb, n, vals.shape[-1]).contiguous()
    band = interp_band(loss_cfg, grid, db, b, nb, wq)
    return grid, db, vals, band


def softmax_loss_cfgs():
    """The focus-loss configurations of the two softmax steps: flow-train
    (dsec.yaml, phase 16) and traj-train (Tab2L5, phase 22)."""
    from motionpriorcmax_tpu_torch.cli.main import traj_train_configs

    _, flow = flow_configs({**DSEC_CONFIG, "loss": {
        **DSEC_CONFIG["loss"], "knn_method": "softmax"}})
    traj = traj_train_configs({**TAB2L5_CONFIG, "loss": {
        **TAB2L5_CONFIG["loss"], "knn_method": "softmax"}}, (H, W),
        TRAIN_STEPS)[2]
    return flow, traj


def softmax_cases(torch, flow_loss, traj_loss):
    """{label: (queries, db, vals, slots, temp)}: "flow", the flow-train
    softmax step's shapes (B=14: G=210, Q=N=19,200, C=2, per-bin band, 1%
    far trajectories), and "traj", the traj-train softmax step's (B=6:
    G=246, Q=N=12,288, C=4 with the flow to the next bin, the per-group
    dynamic band that traj_train_configs sets, no far trajectory: one
    would widen its group's band to the whole grid)."""
    from motionpriorcmax_tpu_torch.ops.cuda import softmax_interp as si

    out = {}
    for label, cfg, b, seed, far in (
            ("flow", flow_loss, DSEC_CONFIG["data"]["batch_size"], 21, 0.01),
            ("traj", traj_loss, TRAIN_BATCH, 23, 0.0)):
        queries, db, vals, band = softmax_inputs(torch, cfg, b, seed, far)
        slots = si.scan_slots(queries, band, db.shape[0], db.shape[1])
        out[label] = (queries, db, vals, slots, float(cfg.softmax_temp))
    return out


# ---------------------------------------------------------------------------
# traj-train (the Tab2L5 experiment); the any-order segment sum
# ---------------------------------------------------------------------------

# config/trajectory_inference/val.yaml composed with
# experiment=raft-spline_evimo2-300ms_ours-selfsup (checkpoint and
# dataset.path set to 'none'), as a dict: the GPU machine has no yaml
# (tests/test_torch_raft_train.py checks that the two agree).
TAB2L5_CONFIG = {
    "dataset": {"load_voxel_grid": True, "normalize_voxel_grid": True,
                "path": "none", "photo_augm": False, "return_ev": True,
                "return_img": True, "name": "evimo2",
                "extended_voxel_grid": True, "downsample": False,
                "flow_every_n_ms": 50, "flow_time": 300},
    "model": {"num_bins": {"context": 41, "correlation": 25},
              "num_iter": {"train": 12, "test": 12},
              "correlation": {"use_cosine_sim": False,
                              "ev": {"target_indices": [8, 16, 24, 32, 40],
                                     "levels": [1, 1, 1, 1, 4],
                                     "radius": [4, 4, 4, 4, 4]},
                              "img": {"levels": 4, "radius": 4}},
              "hidden": {"dim": 128}, "context": {"dim": 128, "norm": "batch"},
              "feature": {"dim": 256, "norm": "instance"},
              "motion": {"dim": 128}, "name": "raft-spline",
              "curve_type": "BEZIER", "detach_bezier": False,
              "bezier_degree": 10, "use_boundary_images": False,
              "use_events": True, "type": "ERAFTPP"},
    "checkpoint": "none",
    "hardware": {"num_workers": 4},
    "batch_size": 8,
    "training": {"batch_size": 6, "learning_rate": 0.0001,
                 "weight_decay": 0.0001, "lr_scheduler": {"use": True}},
    "loss": {"type": "FOCUS", "num_tref": 1, "num_knn": 32, "num_bins": 41,
             "smooth_weight": 0.06, "lut_superpixel_size": 4,
             "focus_loss_norm": "l1", "dist_norm": "l2",
             "scale_iwe_by_dt": True, "mask_image_border": True,
             "interpolation_scheme": "mean", "smooth_type": "on_flow_to_next",
             "polarity_aware_batching": True, "patch_size": 4},
    "run_name": "selfsup_bezier",
}
TRAIN_BATCH = TAB2L5_CONFIG["training"]["batch_size"]
TRAIN_EVENTS = 1 << 19          # per sample, the JAX package's RAFT benchmark
TRAIN_CAPACITY = 1 << 20        # the CLI's --event-capacity default
TRAIN_STEPS = 4                 # 1 warm-up + 2 timed + 1 under torch.profiler


# Row 5 against its plain version: both add each cell's cotangents in f32,
# the kernel with atomics in a run-dependent order, the plain version's
# index_put_(accumulate=True) in its own.  At the path's shapes a cell
# holds a few events; with every cotangent on 8 cells per sample a cell
# holds ~2^17 normal values, whose f32 sums in two orders differ by
# ~sqrt(n) ulps of the partial sums (~1e-5 of the largest cell sum).
TOL_SEGMENT_SUM = 1e-5             # max |diff| / max |plain|
TOL_SEGMENT_SUM_FEW = 1e-4         # the 8-cell case, likewise
TRAJ_LUT = (41 * (H // 4), W // 4)  # the traj-train LUT: 41 bins x 96, 128


def segment_sum_inputs(torch, rows, cols, valid, seed):
    """Cotangents like the path's: normal, zero on padding rows."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    gev = torch.randn(*rows.shape, 2, device="cuda", generator=g)
    return gev * valid[..., None]


def segment_sum_cases(torch, unsorted_batch, loss_cfg):
    """Row 5's inputs, {label: (rows, cols, g [B, M, 2], R, X)}:
      path    phase 8's samples collated without the sort (time order per
              half), cotangents zero on the padding rows (segment_sum_inputs)
      skewed  the same events through skewed_events, still in time order
      traj    the traj-train shape: B=6, 2^19 uniform events per sample in
              capacity 2^20 (the other half padding), LUT [3936, 128]"""
    from motionpriorcmax_tpu_torch.losses.focus import lut_indices

    nb, sp = loss_cfg.num_bins, loss_cfg.lut_superpixel_size
    h, w = loss_cfg.image_shape
    r, x = nb * (h // sp), w // sp
    out = {}
    for label, ev, seed in (
            ("path", unsorted_batch["events"], 31),
            ("skewed", skewed_events(unsorted_batch["events"], h, w, 12), 34)):
        events = torch.from_numpy(ev).cuda()
        rows, cols = lut_indices(loss_cfg, events, nb, sorted_layout=False)
        gev = segment_sum_inputs(torch, rows, cols, events[..., 5], seed)
        out[label] = (rows, cols, gev, r, x)
    gen = torch.Generator(device="cuda").manual_seed(32)
    tb, tr, tx = TRAIN_BATCH, *TRAJ_LUT
    t_rows = torch.randint(0, tr, (tb, TRAIN_CAPACITY), device="cuda",
                           generator=gen, dtype=torch.int32)
    t_cols = torch.randint(0, tx, (tb, TRAIN_CAPACITY), device="cuda",
                           generator=gen, dtype=torch.int32)
    t_valid = (torch.arange(TRAIN_CAPACITY, device="cuda")
               % (TRAIN_CAPACITY // 2) < TRAIN_EVENTS // 2).float()
    t_valid = t_valid[None].expand(tb, -1)
    t_rows = torch.where(t_valid > 0, t_rows, 0).int()
    t_cols = torch.where(t_valid > 0, t_cols, 0).int()
    out["traj"] = (t_rows, t_cols,
                   segment_sum_inputs(torch, t_rows, t_cols, t_valid, 33),
                   tr, tx)
    return out


# ---------------------------------------------------------------------------
# dsec-infer (dsec_inference.yaml)
# ---------------------------------------------------------------------------

# config/dsec_inference.yaml as a dict: the GPU machine has no yaml
# (tests/test_torch_port_isolation.py checks that the two agree).
DSEC_INFERENCE_CONFIG = {
    "common": {"height": 480, "width": 640, "num_bins": 15, "patch_size": 4},
    "model": {"num_basis": 1, "basis_type": "polynomial", "lr": 0.0001,
              "model_type": "default",
              "ckpt_path": "weights/unet_dsec_ours-poly-k1_Tab4L7.pth"},
    "data": {"root_dir": "data/dsec", "norm_type": "mean_std"},
    "output_dir": "runs/dsec_inference",
}


# The parts of a dsec-infer window, in order.
INFER_PARTS = ("pack", "h2d", "voxel_vote", "normalize", "unet", "flow",
               "d2h", "png")


@contextlib.contextmanager
def infer_part_marks(state, seq, mark):
    """Yields `seq` wrapped so that infer_sequence's run over it calls
    `mark(part)` at the end of each of INFER_PARTS: the functions that
    infer_window and infer_sequence look up by name at call time are
    wrapped (and the model gets a forward hook), so the CLI's own code runs
    unchanged.  pack: the sample; h2d: the events to the card, up to the
    voxel vote; unet: the model's forward; flow: from the coefficients;
    d2h: the flow to the host, up to the 60 px cap; png: the cap, the
    encoding and the write."""
    from motionpriorcmax_tpu_torch.ops import events
    from motionpriorcmax_tpu_torch.training import trajectory_net as ttn
    from motionpriorcmax_tpu_torch.utils import flow_io

    def around(fn, before, after):
        def inner(*a, **k):
            if before:
                mark(before)
            res = fn(*a, **k)
            if after:
                mark(after)
            return res
        return inner

    class Marked:
        def __len__(self):
            return len(seq)

        def __getitem__(self, i):
            sample = seq[i]
            mark("pack")
            return sample

    # (module, attribute, part ending at its call, part ending at its return)
    targets = [(events, "voxel_grid_from_events", "h2d", "voxel_vote"),
               (events, "normalize_voxel_grid", None, "normalize"),
               (ttn, "flow_from_coeffs", None, "flow"),
               (flow_io, "scale_optical_flow", "d2h", None),
               (flow_io, "save_flow_png", None, "png")]
    originals = [(mod, attr, getattr(mod, attr))
                 for mod, attr, _, _ in targets]
    hook = state.model.register_forward_hook(lambda m, i, o: mark("unet"))
    try:
        for mod, attr, before, after in targets:
            setattr(mod, attr, around(getattr(mod, attr), before, after))
        yield Marked()
    finally:
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)
        hook.remove()


# ---------------------------------------------------------------------------
# the exact KNN's kernel; flax's BatchNorm kernels
# ---------------------------------------------------------------------------

# The exact KNN's shapes: (label, batch, bins, height, width) of the
# flow-training step (dsec.yaml) and of the traj-train step (Tab2L5).
KNN_PATHS = (("flow", 14, 15, 480, 640), ("traj", 6, 41, 384, 512))
KNN_K = 32
KNN_OPS_PER_PAIR = 5               # csrc/knn_topk.cu: the kernel's bound
# The databases phase 48 runs the kernel on, (name, knn_case's motion in px
# per unit time, shuffled): the focus loss's order, the same points in a
# random order (the scan's start near the queries' rows then helps no
# more), and a flow ten times as large (up to ~100 px across the window).
KNN_VARIANTS = (("ordered", 3.0, False), ("shuffled", 3.0, True),
                ("wide", 30.0, False))
# Distance entries per block of check_knn (~512 MB of f32).
KNN_CHECK_BLOCK_ELEMS = 1 << 27


def knn_case(seed, b, nb, h, w, every=16, motion=3.0, shuffle=False):
    """(queries [Q, 2], database [b * nb, N, 2]) as f32 numpy arrays of a
    focus loss's KNN: the LUT grid at superpixel 4, and trajectories of the
    4 x 4 tiles moved as tests/test_torch_focus_loss.py::make_trajectories
    moves them (grid offsets jittered by U(-0.3, 0.3), N(0, motion) px per
    unit time) at the bin midtimes, with every `every`-th point copied onto
    the next one (exact ties; 0: none) and, with `shuffle`, each
    database's points in a random order."""
    from motionpriorcmax_tpu_torch.losses import FocusLossConfig
    from motionpriorcmax_tpu_torch.losses.focus import lut_grid_points

    rng = np.random.default_rng(seed)
    ys, xs = np.arange(2, h, 4), np.arange(2, w, 4)
    off = np.stack(np.meshgrid(ys, xs, indexing="ij"), -1).reshape(-1, 2)
    c = rng.normal(0, motion, (b, off.shape[0], 2))
    off = off + rng.uniform(-0.3, 0.3, off.shape)
    times = (np.arange(nb) + 0.5) / nb
    db = (off[None, None] + times[None, :, None, None] * c[:, None]).astype(
        np.float32).reshape(b * nb, -1, 2)
    if every:
        db[:, 1::every] = db[:, 0::every][:, :db[:, 1::every].shape[1]]
    if shuffle:
        order = np.argsort(rng.random(db.shape[:2]), axis=1)
        db = np.take_along_axis(db, order[..., None], axis=1)
    grid = lut_grid_points(FocusLossConfig(image_shape=(h, w), num_bins=nb))
    return grid, np.ascontiguousarray(db)


def check_knn(queries, database, k, norm, idx, dist):
    """Hold (idx, dist) of K = min(k, N) nearest to `pairwise_dist`'s
    values v (ops/cuda/knn_topk.py), computed blockwise on the tensors'
    device; an AssertionError names the first breach.  Per query:
      * the K values v[idx] are the K smallest of the row, in order, and
        at equal values the indices ascend;
      * where the K-th and (K+1)-th smallest values differ, the set equals
        torch.topk's (the plain version's selection);
      * where they are equal, the tied indices taken are the lowest ones;
      * dist is bit for bit the plain version's: for l2 the refined
        (q - p)^2 sum of the selected points, for l1 v itself.
    Returns (rows with a tie at the K-th value, of them the rows where
    torch.topk's set equals the lower-index one)."""
    import torch

    from motionpriorcmax_tpu_torch.device import no_tf32
    from motionpriorcmax_tpu_torch.ops.cuda.knn_topk import pairwise_dist

    g, n, _ = database.shape
    nq = queries.shape[0]
    k = min(k, n)
    assert idx.shape == (g, nq, k) and dist.shape == (g, nq, k)
    assert idx.dtype == torch.int64 and dist.dtype == torch.float32
    block = max(1, min(nq, KNN_CHECK_BLOCK_ELEMS // (g * n)))
    tie_rows = topk_lower = 0
    for q0 in range(0, nq, block):
        qb = queries[q0:q0 + block]
        ib, db_ = idx[:, q0:q0 + block], dist[:, q0:q0 + block]
        with no_tf32():
            v = pairwise_dist(qb, database, norm)                # [G, Cq, N]
        kv = torch.gather(v, 2, ib)
        tv, ti = torch.topk(v, min(k + 1, n), dim=-1, largest=False,
                            sorted=True)
        assert torch.equal(kv, tv[..., :k]), "not the K smallest values"
        same = kv[..., 1:] == kv[..., :-1]
        assert bool((ib[..., 1:] > ib[..., :-1])[same].all()), \
            "equal values out of index order"
        if norm == "l2":
            sel = torch.gather(database, 1, ib.reshape(g, -1, 1).expand(
                -1, -1, 2)).reshape(g, -1, k, 2)
            diffs = qb[None, :, None, :] - sel
            want = torch.sum(diffs * diffs, dim=-1)
        else:
            want = kv
        assert torch.equal(db_, want), "distances differ from plain's bits"
        if k == n:
            continue
        tie = tv[..., k - 1] == tv[..., k]
        sets_k = torch.sort(ib, dim=-1).values
        sets_t = torch.sort(ti[..., :k], dim=-1).values
        assert torch.equal(sets_k[~tie], sets_t[~tie]), \
            "index sets differ without a tie at the K-th value"
        if not bool(tie.any()):
            continue
        rows = tie.nonzero(as_tuple=True)
        vv = v[rows]                                             # [R, N]
        thr = tv[..., k - 1][rows]
        mask = vv == thr[:, None]
        need = (kv[rows] == thr[:, None]).sum(-1)
        lowest = mask & (torch.cumsum(mask.int(), -1) <= need[:, None])
        got = torch.zeros_like(mask).scatter_(1, ib[rows], True)
        assert torch.equal(got & mask, lowest), "a tie not to the lower index"
        tie_rows += len(thr)
        topk_lower += int((sets_k[rows] == sets_t[rows]).all(-1).sum())
    return tie_rows, topk_lower


# Phase 49's shapes, as (label, B, C, (H, W), dtype, ReLU fused, norms of
# the path at that shape): the UNet's 18 at B=14, 480x640 (dsec.yaml) and
# RAFT-Spline's 15 context-encoder norms at B=6, 384x512 (Tab2L5).
FLAX_BN_SHAPES = (
    ("unet-64", 14, 64, (480, 640), "bfloat16", True, 4),
    ("unet-128", 14, 128, (240, 320), "bfloat16", True, 4),
    ("unet-256", 14, 256, (120, 160), "bfloat16", True, 4),
    ("unet-512", 14, 512, (60, 80), "bfloat16", True, 4),
    ("unet-1024", 14, 1024, (30, 40), "bfloat16", True, 2),
    ("raft-64", 6, 64, (192, 256), "float32", False, 5),
    ("raft-96", 6, 96, (96, 128), "float32", False, 5),
    ("raft-128", 6, 128, (48, 64), "float32", False, 5),
)
TOL_FLAX_BN_SUMS = 1e-5         # of the sum of |terms| per channel


def flax_bn_inputs(torch, b, c, hw, dtype, seed):
    """x and a cotangent [B, C, H, W] on the card, about half of each
    channel below its mean, and the kernels' coefficients: [3, C] (mean,
    mul, bias) and [5, C] (and gmean, k)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (b, c, *hw)
    mean = torch.linspace(-1.0, 2.0, c, device="cuda")
    x = (torch.randn(shape, generator=g, device="cuda") * 1.3
         + mean[:, None, None])
    dy = torch.randn(shape, generator=g, device="cuda")
    mul = 1.0 + 0.2 * torch.randn(c, generator=g, device="cuda")
    bias = 0.1 * torch.randn(c, generator=g, device="cuda")
    gmean = 0.01 * torch.randn(c, generator=g, device="cuda")
    k = 0.01 * torch.randn(c, generator=g, device="cuda")
    return (x.to(dtype), dy.to(dtype), torch.stack([mean, mul, bias]),
            torch.stack([mean, mul, bias, gmean, k]))


def flax_bn_sums_scale(torch, x, dy=None, coef=None):
    """[2, C] f64 sums of |terms| of flax_bn_reduce's two sums, the scale
    of their rounding."""
    xf = x.double()
    if dy is None:
        return torch.stack([xf.abs().sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))])
    d = (xf - coef[0, :, None, None].double()).abs()
    g = dy.double().abs()
    return torch.stack([g.sum((0, 2, 3)), (g * d).sum((0, 2, 3))])


def flax_bn_check(torch, x, dy, coef3, coef5, relu):
    """Each launch against its plain version on the card: the elementwise
    passes bit for bit, the sums to TOL_FLAX_BN_SUMS of their scale; every
    launch's bits the same in a second call.  Returns the sums' worst
    relative error."""
    from motionpriorcmax_tpu_torch.ops.cuda import flax_batch_norm as fbn

    for args in ((x, coef3, relu), (x, coef5, relu, dy)):
        got, again = fbn.flax_bn_apply(*args), fbn.flax_bn_apply(*args)
        if not torch.equal(got, again):
            raise AssertionError("two apply calls gave other bits")
        want = fbn.apply_plain(*args)
        if not torch.equal(got, want):
            raise AssertionError(
                f"apply differs from plain by "
                f"{float((got.float() - want.float()).abs().max()):.3e}")
    worst = 0.0
    for args in ((x,), (x, dy, coef3, relu)):
        got, again = fbn.flax_bn_reduce(*args), fbn.flax_bn_reduce(*args)
        if not torch.equal(got, again):
            raise AssertionError("two reduce calls gave other bits")
        want = fbn.reduce_plain(*args).double()
        scale = flax_bn_sums_scale(torch, *args[:3]).clamp_min(1.0)
        err = float(((got.double() - want).abs() / scale).max())
        if not err <= TOL_FLAX_BN_SUMS:
            raise AssertionError(f"sums differ from plain by {err:.3e} of "
                                 f"their scale")
        worst = max(worst, err)
    return worst

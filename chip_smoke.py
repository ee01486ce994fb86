#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, one or more lines each; any failure exits non-zero:
  1. environment: card name and count, nvidia-smi name and power limit, and
     the process's TF32 flags, left at torch's defaults as the CLI leaves
     them (the models' forwards turn both off for compute_dtype float32)
  2. build: every kernel source in motionpriorcmax_tpu_torch/csrc, one nvcc
     per source, all started together, for sm_90a, with the -Xptxas -v
     register report
  traj-val (RAFT-Spline Tab2L5 serving, EVIMO2 geometry):
  3. kernel vs plain: the corr-window kernel against its plain PyTorch
     version at the four pyramid-level shapes of the EVIMO2 batch-8 path,
     f32 and bf16 volumes, with coordinates outside the maps
  4. timing (CUDA events, L2 flushed between launches): kernel, its memory
     bound, the plain version, and F.grid_sample (align_corners=True, zero
     padding; the reference's own sampler, never called by the port)
  5. serving: raft_validation_step with seeded random weights on 1 warm-up
     + 3 synthetic B=8 384x512 requests: latency, samples/s, peak memory,
     kernel launches per request (48), finite metrics, TF32 off inside
     every forward
  6. where the time goes: CUDA events around the model's parts over 3 more
     requests, then torch.profiler over one request (idle share)
  7. card vs CPU: the same weights and inputs through the port on the CPU
     (plain lookup) and on the card (kernel) at the small test geometry
  flow-train (self-supervised DSEC flow training, config/flow_training/
  dsec.yaml: 480x640, 15 bins, batch 14, bf16 UNet, capacity 2^20):
  8. host batch: 14 synthetic samples of ~1M events from a numpy seed,
     voxelized on the host and collated by the port (polarity packing,
     LUT-cell sort, cell_ends); the collate time of one batch
  9. kernels vs plain at the path's shapes: the IWE vote forward and
     backward (B=14, M=2^19 per polarity half, 480x640) on cell-sorted
     events (kernel row 3) and on the same events unsorted (row 4), the LUT
     gather (LUT [14, 1800, 160, 2], 2^20 events) and its sorted segment
     sum (S=2); 5% of the warped coordinates far outside the image
 10. timing of each kernel (CUDA events, L2 flushed): kernel, bytes bound
     at 3.35 TB/s, plain version, and one PyTorch call as the yardstick
     (index_put_ accumulate for the vote, advanced indexing for the
     gather, index_add_ for the segment sum; none for the vote backward)
 11. training: train_flow (the CLI's loop) at full width with seeded
     weights on 1 warm-up + 3 timed steps and one val pass with GT flow,
     checkpoint to a temporary directory: step ms, events/s, peak memory,
     kernel launches per step (2 + 2 vote, 1 + 1 gather), finite loss that
     changes, finite val EPE
 12. where the time goes: CUDA events around UNet forward, trajectories,
     KNN + interpolation, warp, vote + blur + objective, backward and
     AdamW over 3 steps, then torch.profiler over one step (idle share)
 13. card vs CPU: one f32 train_step at the test geometry, kernels on the
     card against plain versions on the CPU: loss, gradients, BN statistics
  flow-train with loss.knn_method: softmax and voxel grids built in the
  step (--device-voxelize), on phase 8's batches without their 'voxel':
 14. kernels vs plain at the path's shapes: the softmax interpolation
     forward and backward (G=210 groups, Q=N=19,200, per-bin band rows,
     trajectories moved up to 60 px, 1% far outside the image; the plain
     versions on 4 of the groups, kernel rows 7) and the voxel vote of the
     14 x 2^20 cell-sorted events and of the same events unsorted (row 8)
 15. timing (CUDA events, L2 flushed): kernel, bound (operations for row 7:
     exp2 at the SFU rate and f32 instructions, from nvidia-smi's maximum
     SM clock; bytes for row 8), plain version, and one PyTorch call
     (scaled_dot_product_attention, dense and without band, for the
     forward, with its difference to the kernel; none for the backward;
     index_add_ of the eight taps for the vote)
 16. training: train_flow as in phase 11: launches per step 1 + 1 softmax,
     1 voxel vote and the 6 of phase 11; in the val pass 1 softmax forward
     and 1 voxel vote
 17. where the time goes, as phase 12, with "voxelize" and "softmax
     interpolation" spans
 18. card vs CPU: one f32 train_step of this configuration at the test
     geometry

The line before the last is a JSON object with the kernels' numbers; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12            # f32 outside the tensor cores
RADIUS = 4
K = (2 * RADIUS + 1) ** 2
BATCH, H, W = 8, 384, 512
Q = (H // 8) * (W // 8)
# (targets, h2, w2) per pyramid level of Tab2L5: levels (1, 1, 1, 1, 4).
LEVELS = [(5, 48, 64), (1, 24, 32), (1, 12, 16), (1, 6, 8)]
TOL_KERNEL = 1e-5
TOL_CARD_VS_CPU = 1e-4


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def nvidia_smi_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


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

    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(build_library, names))
    print(f"[build] {len(names)} sources in {time.perf_counter() - t0:.1f} s "
          "(nvcc -gencode arch=compute_90a,code=sm_90a, in parallel)")
    for path, log in built:
        print(f"[build] {path.name}")
        for line in log.splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                print(f"[build]   {line.strip()}")


def level_inputs(torch, t, h2, w2, lvl, seed, dtype):
    """A level volume and window centres like the path's: the query pixel
    scaled to the level plus a flow-like offset, with 5% of the centres far
    outside or just outside the map."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    corr = torch.randn(t, BATCH, Q, h2, w2, device=dev, generator=g).to(dtype)
    qy = (torch.arange(Q, device=dev) // (W // 8)).float()
    qx = (torch.arange(Q, device=dev) % (W // 8)).float()
    scale = 2.0 ** lvl
    cx = (qx / scale + 3 * torch.randn(t, BATCH, Q, device=dev, generator=g))
    cy = (qy / scale + 3 * torch.randn(t, BATCH, Q, device=dev, generator=g))
    far = torch.rand(t, BATCH, Q, device=dev, generator=g) < 0.05
    cx = torch.where(far, torch.full_like(cx, -1e6), cx)
    cy = torch.where(far & (qx > 32), torch.full_like(cy, h2 + 0.5), cy)
    return corr.contiguous(), cx.contiguous(), cy.contiguous()


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


def time_ms(torch, fn, flush, reps=20, warmup=3):
    """Median ms of fn() over reps launches, L2 flushed before each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_kernel(torch):
    from torch.nn import functional as F

    from motionpriorcmax_tpu_torch.ops.cuda import corr_window as cw

    max_err = 0.0
    for lvl, (t, h2, w2) in enumerate(LEVELS):
        for dtype in (torch.float32, torch.bfloat16):
            corr, cx, cy = level_inputs(torch, t, h2, w2, lvl, 100 + lvl, dtype)
            out_k = torch.full((BATCH, t * K, H // 8, W // 8), float("nan"),
                               device="cuda")
            out_p = torch.full_like(out_k, float("nan"))
            cw.corr_window_lookup(corr, cx, cy, RADIUS, out_k, 0)
            cw.corr_window_lookup_plain(corr, cx, cy, RADIUS, out_p, 0)
            torch.cuda.synchronize()
            if not torch.isfinite(out_k).all():
                fail(f"level {lvl + 1} {dtype}: kernel left non-finite outputs")
            err = float((out_k - out_p).abs().max().item())
            max_err = max(max_err, err)
            print(f"[kernel-vs-plain] level {lvl + 1} N={corr.shape[0] * BATCH * Q}"
                  f" map {h2}x{w2} {str(dtype)[6:]}: max_abs_diff={err:.3e} "
                  f"(bound {TOL_KERNEL:g})")
            if err > TOL_KERNEL:
                fail(f"kernel disagrees with plain at level {lvl + 1} {dtype}")
            del corr, cx, cy, out_k, out_p
    torch.cuda.empty_cache()

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    for lvl, (t, h2, w2) in enumerate(LEVELS):
        corr, cx, cy = level_inputs(torch, t, h2, w2, lvl, 200 + lvl,
                                    torch.float32)
        out = torch.empty(BATCH, t * K, H // 8, W // 8, device="cuda")
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
        k_ms = time_ms(torch, lambda: cw.corr_window_lookup(
            corr, cx, cy, RADIUS, out, 0), flush)
        p_ms = time_ms(torch, lambda: cw.corr_window_lookup_plain(
            corr, cx, cy, RADIUS, out, 0), flush)
        l_ms = time_ms(torch, lambda: F.grid_sample(
            img, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True), flush)
        nbytes = needed_bytes(torch, corr, cx, cy)
        flops = n * K * 7
        bound = max(nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS) * 1e3
        print(f"[timing] level {lvl + 1} N={n} map {h2}x{w2} f32: "
              f"kernel={k_ms * 1e3:.1f} us bound={bound * 1e3:.1f} us "
              f"({nbytes / 1e6:.1f} MB needed, bytes-bound) "
              f"plain={p_ms * 1e3:.1f} us grid_sample={l_ms * 1e3:.1f} us")
        for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", bound),
                       ("library_ms", l_ms)):
            totals[key] += v
        del corr, cx, cy, out, grid, img, gx, gy
    del flush
    torch.cuda.empty_cache()
    print(f"[timing] one refinement iteration (4 launches): "
          f"kernel={totals['ms'] * 1e3:.1f} us bound={totals['bound_ms'] * 1e3:.1f}"
          f" us plain={totals['plain_ms'] * 1e3:.1f} us "
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


def phase_serving(torch, model, requests, ts):
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
        print(f"[serving] request {i}{' (warm-up)' if i == 0 else ''}: "
              f"{dt * 1e3:.1f} ms, corr_window launches {per_request[-1]}")
    launches = cw.corr_window_lookup.launches
    peak = torch.cuda.max_memory_allocated()
    for h in hooks:
        h.remove()
    results = bank.compute()
    if any(n != 48 for n in per_request):
        fail(f"expected 48 corr_window launches per request, got {per_request}")
    if not all(np.isfinite(v) for v in results.values()):
        fail("non-finite metrics in the bank")
    if seen != {(False, False)}:
        fail(f"the f32 forward ran with TF32 flags (matmul, cudnn) {seen}")
    mean = float(np.mean(lat))
    print(f"[serving] Tab2L5 B={BATCH} {H}x{W} f32, 12 iterations: latency "
          f"mean {mean * 1e3:.1f} ms over {len(lat)} requests "
          f"({', '.join(f'{x * 1e3:.1f}' for x in lat)}), "
          f"{BATCH / mean:.2f} samples/s, peak memory {peak / 2**30:.2f} GiB")
    print(f"[serving] {len(results)} metrics finite; val/masked_TEPE="
          f"{results['val/masked_TEPE']:.4f} val/epe={results['val/epe']:.4f}; "
          f"TF32 (matmul, cudnn) inside the forward: {sorted(seen)}")
    return launches


def phase_breakdown(torch, model, host_batch, ts):
    """Where a request's time goes, with the batch already on the card."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from motionpriorcmax_tpu_torch.models.raft_spline import raft
    from motionpriorcmax_tpu_torch.training.raft_spline import \
        raft_validation_step

    batch = {k: v.cuda() for k, v in host_batch.items()}
    spans = defaultdict(list)            # part -> [(start, end) events]

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def request():
        spans.clear()
        t0 = time.perf_counter()
        start = event()
        raft_validation_step(model, batch, ts)
        end = event()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        parts = {k: sum(s.elapsed_time(e) for s, e in v)
                 for k, v in spans.items()}
        parts["rest"] = start.elapsed_time(end) - sum(parts.values())
        return wall, start.elapsed_time(end), parts

    # Events around the encoders and the update block (module hooks) and
    # around the corr functions raft.py calls (wrapped for this phase only).
    starts = defaultdict(list)
    hooks = []
    for name in ("fnet_ev", "cnet", "update_block"):
        mod = getattr(model, name)
        hooks.append(mod.register_forward_pre_hook(
            lambda m, i, name=name: starts[name].append(event())))
        hooks.append(mod.register_forward_hook(
            lambda m, i, o, name=name: spans[name].append(
                (starts[name].pop(), event()))))

    def wrap(name, fn):
        def inner(*a, **k):
            s = event()
            out = fn(*a, **k)
            spans[name].append((s, event()))
            return out
        return inner

    wrapped = ("compute_corr_volume", "build_corr_pyramid",
               "lookup_corr_pyramid")
    originals = {name: getattr(raft, name) for name in wrapped}
    for name in wrapped:
        setattr(raft, name, wrap(name, originals[name]))
    try:
        request()                                            # warm-up
        runs = [request() for _ in range(3)]
    finally:
        for name in wrapped:
            setattr(raft, name, originals[name])
        for h in hooks:
            h.remove()
    walls = [r[0] for r in runs]
    dev_ms = float(np.median([r[1] for r in runs]))
    print(f"[breakdown] batch on the card, 3 requests after 1 warm-up: wall "
          f"median {np.median(walls):.2f} ms "
          f"({', '.join(f'{x:.2f}' for x in walls)}), between CUDA events "
          f"median {dev_ms:.2f} ms")
    for name in ("fnet_ev", "compute_corr_volume", "build_corr_pyramid",
                 "cnet", "lookup_corr_pyramid", "update_block", "rest"):
        med = float(np.median([r[2].get(name, 0.0) for r in runs]))
        print(f"[breakdown]   {name:20s} {med:9.2f} ms  "
              f"{100 * med / dev_ms:5.1f}%")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _, _ = request()
    # Kernel events only: an operator's device time repeats its kernels'.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("[breakdown] torch.profiler recorded no device time")
        return
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[breakdown] torch.profiler, one request: kernels busy "
          f"{busy_ms:.2f} ms of {wall:.2f} ms wall, idle share "
          f"{1 - busy_ms / wall:.3f}, "
          f"{sum(e.count for e in kernels)} kernel launches")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:8]:
        print(f"[breakdown]   {e.self_device_time_total / 1e3:9.2f} ms "
              f"{e.count:5d}x  {e.key[:80]}")
    for e in kernels:
        if "corr_window" in e.key:
            print(f"[breakdown]   corr_window kernel: "
                  f"{e.self_device_time_total / 1e3:.2f} ms in {e.count} "
                  f"launches")


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
FLOW_STEPS = 4                     # 1 warm-up + 3 timed
# Kernel vs plain on the card: the vote adds a pixel's votes with atomics
# in run-dependent order (a few ulps of the pixel's sum); its backward and
# the segment sum use the same f32 sums as their plain versions up to
# fused multiply-adds and summation order; the gather is a selection.
TOL_VOTE_FWD = 1e-5                # relative to the image's largest value
TOL_VOTE_BWD = 1e-5                # relative to the largest cotangent
TOL_SEGSUM = 1e-5                  # relative to the largest cell sum
# Rows 7 and 8: the interpolation sums its weights in another order than
# the plain version's matrix product, with fused multiply-adds; the voxel
# vote adds a voxel's votes with atomics in run-dependent order.
TOL_SOFTMAX = 1e-5                 # relative to the largest plain value
TOL_VOXEL = 1e-5                   # relative to the grid's largest value
TOL_TRAIN_LOSS = 1e-4              # card vs CPU, relative
TOL_TRAIN_GRAD = 1e-4              # card vs CPU, of each tensor's largest
TOL_TRAIN_BN = 1e-4                # card vs CPU, of each buffer's largest


def flow_configs(tree, **model_overrides):
    from motionpriorcmax_tpu_torch.cli.main import flow_configs as build
    from motionpriorcmax_tpu_torch.config import propagate_config

    tree = propagate_config(copy.deepcopy(tree))
    tree["model"].update(model_overrides)
    return build(tree)


def flow_samples(seed, n_samples, n_events, h, w, nb, gt=False):
    """DSEC-like samples from a numpy seed: rectified (float) pixel
    coordinates, sorted normalized times, random polarity, host voxel
    grids; with `gt` a GT flow and validity mask."""
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
        s = {"pos_events": ev[ev[:, 3] == 1], "neg_events": ev[ev[:, 3] == 0],
             "voxel": voxelize_normalized_host(ev, nb, h, w)}
        if gt:
            s["forward_flow"] = (3 * rng.standard_normal((2, h, w))
                                 ).astype(np.float32)
            s["flow_valid"] = rng.random((h, w)) < 0.7
        samples.append(s)
    return samples


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
    train = {k: v for k, v in batch.items()
             if k not in ("forward_flow", "flow_valid")}
    return train, batch


def vote_inputs(torch, events, npos, seed):
    """Warped coordinates and weights of one polarity half, the layout
    make_iwes votes: (y, x) plus a smooth flow, 5% of them far outside."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    y, x = events[..., 0], events[..., 1]
    coords = torch.stack([y + 8 * torch.sin(x / 50), x + 6 * torch.cos(y / 40)],
                         dim=-1)
    far = torch.rand(coords.shape[:2], device="cuda", generator=g) < 0.05
    sign = torch.where(torch.rand(coords.shape[:2], device="cuda",
                                  generator=g) < 0.5, -1.0, 1.0)
    coords = torch.where(far[..., None], (sign * 1e9)[..., None], coords)
    weight = events[..., 5] * (1 - (events[..., 2] - 0.5).abs())
    return coords[:, :npos], weight[:, :npos]       # batch-strided views


def time_kernel(torch, label, fn, plain, library, flush, nbytes):
    k_ms = time_ms(torch, fn, flush)
    p_ms = time_ms(torch, plain, flush, reps=5, warmup=1)
    l_ms = (time_ms(torch, library, flush, reps=5, warmup=1)
            if library is not None else None)
    bound = nbytes / H100_BYTES_PER_S * 1e3
    lib = f"{l_ms * 1e3:.1f} us" if l_ms is not None else "none"
    print(f"[flow-timing] {label}: kernel={k_ms * 1e3:.1f} us "
          f"bound={bound * 1e3:.1f} us ({nbytes / 1e6:.1f} MB, bytes) "
          f"plain={p_ms * 1e3:.1f} us library={lib}")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": l_ms}


def check_close(label, got, want, rel_tol):
    err = float((got - want).abs().max().item())
    scale = max(1.0, float(want.abs().max().item()))
    tol = rel_tol * scale
    print(f"[flow-kernel-vs-plain] {label}: max_abs_diff={err:.3e} "
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
    ends = torch.from_numpy(batch["lut_cell_ends"]).cuda()
    b, m, _ = events.shape
    coords, weight = vote_inputs(torch, events, npos, 11)
    gimg = torch.randn(b, h, w, device="cuda")
    out = {}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    # Vote (rows 3 and 4): sorted half as the path votes it, then the same
    # events in random order.
    perm = torch.argsort(torch.rand(b, npos, device="cuda"), dim=1)
    unsorted = (torch.gather(coords, 1, perm[..., None].expand(-1, -1, 2)),
                torch.gather(weight, 1, perm))
    nnz = int((weight != 0).sum())
    fwd_bytes = b * npos * 4 + nnz * 8 + b * h * w * 4
    bwd_bytes = b * npos * 4 + nnz * 8 + b * h * w * 4 + b * npos * 8
    for name in ("iwe_vote_fwd", "iwe_vote_bwd"):
        out[name] = {}
    for label, (c, v) in (("sorted", (coords, weight)), ("unsorted", unsorted)):
        k_out = iv.iwe_vote_fwd(c, v, h, w)
        p_out = iv.iwe_vote_fwd_plain(c, v, h, w)
        e_f = check_close(f"iwe_vote_fwd {label} B={b} M={npos} {h}x{w}",
                          k_out, p_out, TOL_VOTE_FWD)
        k_dc, _ = iv.iwe_vote_bwd(c, v, gimg, h, w, need_dweight=False)
        p_dc, _ = iv.iwe_vote_bwd_plain(c, v, gimg, h, w, need_dweight=False)
        e_b = check_close(f"iwe_vote_bwd {label}", k_dc, p_dc, TOL_VOTE_BWD)
        del k_out, p_out, k_dc, p_dc
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
            torch, f"iwe_vote_fwd {label}",
            lambda: iv.iwe_vote_fwd(c, v, h, w),
            lambda: iv.iwe_vote_fwd_plain(c, v, h, w),
            lambda: img.zero_().index_put_((idx,), val, accumulate=True),
            flush, fwd_bytes)
        bw = time_kernel(
            torch, f"iwe_vote_bwd {label}",
            lambda: iv.iwe_vote_bwd(c, v, gimg, h, w, need_dweight=False),
            lambda: iv.iwe_vote_bwd_plain(c, v, gimg, h, w,
                                          need_dweight=False),
            None, flush, bwd_bytes)
        del idx, val, img
        for name, nums, err in (("iwe_vote_fwd", f, e_f),
                                ("iwe_vote_bwd", bw, e_b)):
            if label == "sorted":
                out[name].update(nums, max_abs_err=err)
            else:
                out[name].update(unsorted_ms=nums["ms"],
                                 unsorted_plain_ms=nums["plain_ms"],
                                 unsorted_library_ms=nums["library_ms"],
                                 unsorted_max_abs_err=err)
    del coords, weight, unsorted, perm, gimg
    torch.cuda.empty_cache()

    # LUT gather and its segment sum (row 6), the path's indices.
    hq, wq = h // loss_cfg.lut_superpixel_size, w // loss_cfg.lut_superpixel_size
    nb = loss_cfg.num_bins
    lut = torch.randn(b, hq * nb, wq, 2, device="cuda")
    rows, cols = lut_indices(loss_cfg, events, nb, sorted_layout=True)
    # The path's cotangent is zero on padding rows (their vote weight is 0);
    # they still form the long run of cell 0 that the kernel must walk.
    gev = torch.randn(b, m, 2, device="cuda") * events[..., 5:6]
    cells = hq * nb * wq
    e_g = check_close(f"lut_gather_fwd B={b} M={m} LUT {tuple(lut.shape[1:])}",
                      lg.lut_gather_fwd(lut, rows, cols),
                      lg.lut_gather_plain(lut, rows, cols), 0.0)
    e_s = check_close(f"lut_segsum_bwd S={ends.shape[1] // cells}",
                      lg.lut_segsum_bwd(gev, ends, cells),
                      lg.lut_segsum_plain(gev, ends, cells), TOL_SEGSUM)
    flat = (torch.arange(b, device="cuda")[:, None] * cells
            + rows.long() * wq + cols.long()).reshape(-1)
    lut_flat = lut.reshape(-1, 2)
    dl = torch.zeros(b * cells, 2, device="cuda")
    gflat = gev.reshape(-1, 2)
    out["lut_gather_fwd"] = time_kernel(
        torch, "lut_gather_fwd", lambda: lg.lut_gather_fwd(lut, rows, cols),
        lambda: lg.lut_gather_plain(lut, rows, cols),
        lambda: lut_flat[flat], flush,
        b * m * 8 + b * m * 2 * 4 + lut.numel() * 4)
    out["lut_gather_fwd"]["max_abs_err"] = e_g
    out["lut_segsum_bwd"] = time_kernel(
        torch, "lut_segsum_bwd", lambda: lg.lut_segsum_bwd(gev, ends, cells),
        lambda: lg.lut_segsum_plain(gev, ends, cells),
        lambda: dl.zero_().index_add_(0, flat, gflat), flush,
        gev.numel() * 4 + ends.numel() * 4 + b * cells * 2 * 4)
    out["lut_segsum_bwd"]["max_abs_err"] = e_s
    del events, ends, lut, rows, cols, gev, flat, dl, flush
    torch.cuda.empty_cache()
    return out


def sm_clock_hz() -> float:
    """The card's maximum SM clock as nvidia-smi reports it."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


def softmax_inputs(torch, loss_cfg, b, seed):
    """The interpolation's operands at the step's shapes: the LUT grid as
    queries; db = linear trajectories (flow up to 60 px at t = 1, 1% of
    them far outside the image) at the bin midtimes; values = their flow to
    t_ref = 0.37; the per-bin band rows the step computes."""
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
    far = torch.rand(b, n, device=dev, generator=g) < 0.01
    # Far trajectories: >= 3,000 px out of the image even at bin 0.
    flow = torch.where(far[..., None], torch.full_like(flow, 1e5), flow)
    t_mid = (torch.arange(nb, device=dev, dtype=torch.float32) + 0.5) / nb
    db = grid[None, None] + flow[:, None] * t_mid[None, :, None, None]
    vals = flow[:, None] * (0.37 - t_mid)[None, :, None, None]
    db = db.reshape(b * nb, n, 2).contiguous()
    vals = vals.reshape(b * nb, n, 2).contiguous()
    band = interp_band(loss_cfg, grid, db, b, nb, wq)
    return grid, db, vals, band


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
    temp = float(loss_cfg.softmax_temp)
    queries, db, vals, band = softmax_inputs(torch, loss_cfg, b, 21)
    g, n, c = vals.shape
    q = queries.shape[0]
    slots = si.scan_slots(queries, band, g, n)
    pairs = si.scanned_pairs(slots, q)
    print(f"[softmax-kernels] G={g} Q={q} N={n} C={c}, per-bin band: "
          f"{pairs:.4g} (query, slot) pairs scanned per pass, "
          f"{pairs / (g * q * n):.3f} of the dense {g * q * n:.4g}")
    # The plain versions hold one dense [Q, N] matrix per group: 4 groups
    # (the first and last bin of two samples) against the kernels' 210.
    sub = torch.tensor([0, nb - 1, g - nb, g - 1], device="cuda")
    k_out, k_den = si.softmax_interp_fwd(queries, db, vals, temp, slots)
    p_out, p_den = si.softmax_interp_fwd_plain(queries, db[sub], vals[sub],
                                               temp, slots[sub])
    e_f = check_close(f"softmax_interp_fwd G={g} Q=N={q} (groups "
                      f"{sub.tolist()} vs plain)", k_out[sub], p_out,
                      TOL_SOFTMAX)
    check_close("softmax_interp_fwd den", k_den[sub], p_den, TOL_SOFTMAX)
    gout = torch.randn(g, q, c, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(22))
    gs = (gout / torch.clamp(k_den, min=1e-30)[..., None]).contiguous()
    k_dv = si.softmax_interp_bwd(queries, db, gs, temp, slots)
    p_dv = si.softmax_interp_bwd_plain(queries, db[sub], gs[sub], temp,
                                       slots[sub])
    e_b = check_close("softmax_interp_bwd (same groups)", k_dv[sub], p_dv,
                      TOL_SOFTMAX)
    del p_out, p_den, p_dv
    torch.cuda.empty_cache()

    # Bound: operations.  Per pair one exp2 on the SFUs (16 per SM per
    # clock) and f32 instructions at 128 per SM per clock: fwd sub, sub,
    # mul, fma, the denominator add and C fmas; bwd the same but the add.
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = sm_clock_hz()
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
    for name, fp32_ops, fn, plain, library, err, nbytes in (
            ("softmax_interp_fwd", 5 + c,
             lambda: si.softmax_interp_fwd(queries, db, vals, temp, slots),
             lambda: si.softmax_interp_fwd_plain(queries, db, vals, temp,
                                                 slots),
             lib, e_f, q * 8 + g * n * (8 + 4 * c) + g * q * 4 * (c + 1)),
            ("softmax_interp_bwd", 4 + c,
             lambda: si.softmax_interp_bwd(queries, db, gs, temp, slots),
             lambda: si.softmax_interp_bwd_plain(queries, db, gs, temp,
                                                 slots),
             None, e_b, q * 8 + g * n * 8 + g * q * 4 * c + g * n * 4 * c)):
        k_ms = time_ms(torch, fn, flush, reps=10, warmup=2)
        p_ms = time_ms(torch, plain, flush, reps=1, warmup=1)
        l_ms = (time_ms(torch, library, flush, reps=3, warmup=1)
                if library is not None else None)
        sfu_ms = pairs / (16 * sms * clock) * 1e3
        f32_ms = pairs * fp32_ops / (128 * sms * clock) * 1e3
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        bound = max(sfu_ms, f32_ms, bytes_ms)
        lib_txt = (f"{l_ms * 1e3:.1f} us (dense, no band; max |diff| to "
                   f"the unbanded kernel {sdpa_err:.3e})" if l_ms is not None
                   else "none")
        print(f"[softmax-timing] {name}: kernel={k_ms * 1e3:.1f} us "
              f"bound={bound * 1e3:.1f} us (operations: exp2 {sfu_ms * 1e3:.1f}"
              f" us at 16/SM/clk, f32 {f32_ms * 1e3:.1f} us at 128/SM/clk, "
              f"{sms} SMs at {clock / 1e6:.0f} MHz; bytes {bytes_ms * 1e3:.1f}"
              f" us) plain={p_ms * 1e3:.1f} us library={lib_txt}")
        out[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                     "bound_by": "operations", "library_ms": l_ms,
                     "max_abs_err": err, "pairs": pairs}
    out["softmax_interp_fwd"]["library_max_abs_diff"] = sdpa_err
    del queries, db, vals, slots, k_out, k_den, gout, gs, k_dv, lib
    torch.cuda.empty_cache()

    # Row 8: the step's events (cell-sorted per polarity half), then the
    # same events in random order.
    events = torch.from_numpy(batch["events"]).cuda()
    m = events.shape[1]
    perm = torch.argsort(torch.rand(b, m, device="cuda"), dim=1)
    unsorted = torch.gather(events, 1, perm[..., None].expand(-1, -1, 6))
    del perm
    nbytes = events.numel() * 4 + b * nb * h * w * 4
    img = torch.zeros(b * nb * h * w, device="cuda")
    for label, ev in (("sorted", events), ("unsorted", unsorted)):
        err = check_close(f"voxel_vote {label} B={b} M={m} {nb}x{h}x{w}",
                          vv.voxel_vote(ev, nb, h, w),
                          vv.voxel_vote_plain(ev, nb, h, w), TOL_VOXEL)
        idx, val = vv.voxel_taps(ev, nb, h, w)
        idx, val = idx.reshape(-1), val.reshape(-1)
        nums = time_kernel(
            torch, f"voxel_vote {label}", lambda: vv.voxel_vote(ev, nb, h, w),
            lambda: vv.voxel_vote_plain(ev, nb, h, w),
            lambda: img.zero_().index_add_(0, idx, val), flush, nbytes)
        if label == "sorted":
            out["voxel_vote"] = dict(nums, max_abs_err=err)
        else:
            out["voxel_vote"].update(unsorted_ms=nums["ms"],
                                     unsorted_plain_ms=nums["plain_ms"],
                                     unsorted_library_ms=nums["library_ms"],
                                     unsorted_max_abs_err=err)
        del idx, val
    del events, unsorted, img, flush
    torch.cuda.empty_cache()
    return out


FLOW_KERNELS = ("iwe_vote_fwd", "iwe_vote_bwd", "lut_gather_fwd",
                "lut_segsum_bwd")
SOFTMAX_KERNELS = ("softmax_interp_fwd", "softmax_interp_bwd", "voxel_vote")
# Launches per train step and in the val pass of the two flow-train paths.
EXACT_STEP = {"iwe_vote_fwd": 2, "iwe_vote_bwd": 2, "lut_gather_fwd": 1,
              "lut_segsum_bwd": 1, "softmax_interp_fwd": 0,
              "softmax_interp_bwd": 0, "voxel_vote": 0}
EXACT_VAL = {**EXACT_STEP, "iwe_vote_bwd": 0, "lut_segsum_bwd": 0}
SOFTMAX_STEP = {**EXACT_STEP, "softmax_interp_fwd": 1,
                "softmax_interp_bwd": 1, "voxel_vote": 1}
SOFTMAX_VAL = {**SOFTMAX_STEP, "iwe_vote_bwd": 0, "lut_segsum_bwd": 0,
               "softmax_interp_bwd": 0}


def kernel_wrappers():
    from motionpriorcmax_tpu_torch.ops.cuda import iwe_vote as iv
    from motionpriorcmax_tpu_torch.ops.cuda import lut_gather as lg
    from motionpriorcmax_tpu_torch.ops.cuda import softmax_interp as si
    from motionpriorcmax_tpu_torch.ops.cuda import voxel_vote as vv

    fns = {"iwe_vote_fwd": iv.iwe_vote_fwd, "iwe_vote_bwd": iv.iwe_vote_bwd,
           "lut_gather_fwd": lg.lut_gather_fwd,
           "lut_segsum_bwd": lg.lut_segsum_bwd,
           "softmax_interp_fwd": si.softmax_interp_fwd,
           "softmax_interp_bwd": si.softmax_interp_bwd,
           "voxel_vote": vv.voxel_vote}
    return fns


def phase_flow_train(torch, cfg, loss_cfg, train_batch, val_batch, smi_line,
                     want, val_want, tag="flow-train"):
    """train_flow at full width: 1 warm-up + 3 timed steps, one val pass,
    a checkpoint.  Fails unless every step launches `want` and the val
    pass `val_want`.  Returns the kernels' launch counts over the run."""
    import tempfile

    from motionpriorcmax_tpu_torch.training.loop import train_flow

    fns = kernel_wrappers()
    marks = []          # (time, launch counts) at every step boundary

    def mark():
        torch.cuda.synchronize()
        marks.append((time.perf_counter(),
                      {k: f.launches for k, f in fns.items()}))

    def timed_batches():
        for _ in range(FLOW_STEPS):
            mark()
            yield train_batch
        mark()

    npos = train_batch["num_pos_events"]
    with tempfile.TemporaryDirectory() as workdir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for f in fns.values():
            f.launches = 0
        train_flow(cfg, loss_cfg, timed_batches(), [val_batch], workdir,
                   device="cuda", max_epochs=1, num_pos_events=npos,
                   log_every=1, seed=0)
        launches = {k: f.launches for k, f in fns.items()}
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
              f"{losses[i]:.6f}, launches {counts}")
    if any(counts != want for _, counts in steps):
        fail(f"expected {want} launches per step, got {[c for _, c in steps]}")
    in_val = {k: launches[k] - sum(c[k] for _, c in steps) for k in launches}
    if in_val != val_want:
        fail(f"expected {val_want} launches in the val pass, got {in_val}")
    if len(losses) != FLOW_STEPS or not all(np.isfinite(losses)):
        fail(f"train losses {losses}")
    if len(set(losses)) < 2:
        fail(f"the loss did not change between steps: {losses}")
    if not epe or not np.isfinite(epe[0]):
        fail(f"val EPE {epe}")
    if not ckpts:
        fail("no checkpoint written")
    timed = [dt for dt, _ in steps[1:]]
    mean = float(np.mean(timed))
    h, w = cfg.image_shape
    print(f"[{tag}] dsec.yaml B={b} {h}x{w} {cfg.compute_dtype} UNet, "
          f"knn_method {loss_cfg.knn_method}, "
          f"{'host' if 'voxel' in train_batch else 'device'} voxel, "
          f"capacity {m}: "
          f"step mean {mean * 1e3:.1f} ms over {len(timed)} steps "
          f"({', '.join(f'{x * 1e3:.1f}' for x in timed)}), "
          f"{b * m / mean:.4g} events/s padded ({valid / mean:.4g} valid), "
          f"peak memory {peak / 2**30:.2f} GiB; val pass EPE {epe[0]:.4f} "
          f"(launches {in_val}); checkpoints {ckpts}; card {smi_line}")
    return launches


def phase_flow_breakdown(torch, cfg, loss_cfg, train_batch,
                         tag="flow-breakdown"):
    """Where one train step's time goes, with the batch on the card."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from motionpriorcmax_tpu_torch.losses import focus
    from motionpriorcmax_tpu_torch.ops import gradients
    from motionpriorcmax_tpu_torch.training import trajectory_net as ttn
    from motionpriorcmax_tpu_torch.training.loop import to_device

    state = ttn.create_train_state(cfg, "cuda",
                                   torch.Generator().manual_seed(0))
    batch = to_device(train_batch, torch.device("cuda"))
    npos = train_batch["num_pos_events"]
    gen = torch.Generator().manual_seed(1)
    spans = defaultdict(list)

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def wrap(name, fn):
        def inner(*a, **k):
            s = event()
            res = fn(*a, **k)
            spans[name].append((s, event()))
            return res
        return inner

    # (module, attribute, span name): functions the step looks up by name.
    interp = ("softmax interpolation" if loss_cfg.knn_method == "softmax"
              else "knn + interpolation")
    targets = [(ttn, "voxelize_batch_on_device", "voxelize"),
               (ttn, "calculate_trajectories", "trajectories"),
               (focus, "interpolate_flow", interp),
               (focus, "warp_events", "warp (LUT gather)"),
               (focus, "make_iwes", "vote + blur + objective"),
               (gradients, "focus_objective", "vote + blur + objective"),
               (focus, "calculate_smooth_loss", "vote + blur + objective"),
               (torch.Tensor, "backward", "backward"),
               (state.optimizer, "step", "AdamW")]
    originals = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]
    unet = state.model.unet
    starts = []
    hooks = [unet.register_forward_pre_hook(lambda m, i: starts.append(event())),
             unet.register_forward_hook(lambda m, i, o: spans["UNet forward"]
                                        .append((starts.pop(), event())))]

    def step():
        spans.clear()
        t0 = time.perf_counter()
        start = event()
        ttn.train_step(state, batch, gen, cfg, loss_cfg, npos)
        end = event()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        parts = {k: sum(s.elapsed_time(e) for s, e in v)
                 for k, v in spans.items()}
        parts["rest"] = start.elapsed_time(end) - sum(parts.values())
        return wall, start.elapsed_time(end), parts

    for mod, attr, name in targets:
        setattr(mod, attr, wrap(name, getattr(mod, attr)))
    try:
        step()                                              # warm-up
        runs = [step() for _ in range(3)]
    finally:
        for mod, attr, fn in originals:
            if mod is state.optimizer:
                del mod.step
            else:
                setattr(mod, attr, fn)
        for h in hooks:
            h.remove()
    dev_ms = float(np.median([r[1] for r in runs]))
    print(f"[{tag}] batch on the card, 3 steps after 1 warm-up: "
          f"wall median {np.median([r[0] for r in runs]):.1f} ms, between "
          f"CUDA events median {dev_ms:.1f} ms")
    names = ["voxelize", "UNet forward", "trajectories", interp,
             "warp (LUT gather)", "vote + blur + objective", "backward",
             "AdamW", "rest"]
    for name in names:
        med = float(np.median([r[2].get(name, 0.0) for r in runs]))
        print(f"[{tag}]   {name:24s} {med:9.2f} ms  "
              f"{100 * med / dev_ms:5.1f}%")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _, _ = step()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"[{tag}] torch.profiler recorded no device time")
        return
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[{tag}] torch.profiler, one step: kernels busy "
          f"{busy_ms:.1f} ms of {wall:.1f} ms wall, idle share "
          f"{1 - busy_ms / wall:.3f}, {sum(e.count for e in kernels)} "
          f"kernel launches")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:10]:
        print(f"[{tag}]   {e.self_device_time_total / 1e3:9.2f} ms "
              f"{e.count:5d}x  {e.key[:80]}")
    for e in kernels:
        if any(k in e.key for k in ("iwe_vote", "lut_gather", "lut_segsum",
                                    "softmax_interp", "voxel_vote")):
            print(f"[{tag}]   port kernel {e.key[:60]}: "
                  f"{e.self_device_time_total / 1e3:.2f} ms in {e.count} "
                  f"launches")


def phase_flow_card_vs_cpu(torch, loss_overrides=None, device_voxel=False,
                           want=EXACT_STEP, tag="flow-card-vs-cpu"):
    """One f32 train_step at the test geometry on the CPU (plain versions)
    and on the card (kernels), same weights, batch and t_ref; with
    `device_voxel` the batch carries no 'voxel'."""
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
        lut_cell_sort_params=((h, w), nb, loss_cfg.lut_superpixel_size))
    if device_voxel:
        del batch["voxel"]
    times = torch.cat([torch.tensor([0.37]),
                       (torch.arange(nb) + 0.5) / nb]).float()
    fns = kernel_wrappers()
    before = {k: f.launches for k, f in fns.items()}
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
    launches = {k: fns[k].launches - before[k] for k in fns}
    (l_c, g_c, s_c), (l_g, g_g, s_g) = results["cpu"], results["cuda"]
    loss_rel = abs(l_g - l_c) / abs(l_c)
    grad_rel = max(float((g_g[n] - g_c[n]).abs().max()
                         / g_c[n].abs().max().clamp(min=1e-30)) for n in g_c)
    bn_rel = max(float((s_g[n] - s_c[n]).abs().max()
                       / s_c[n].abs().max().clamp(min=1e-30)) for n in s_c)
    print(f"[{tag}] f32 train_step {h}x{w} B=2, knn_method "
          f"{loss_cfg.knn_method}, {'device' if device_voxel else 'host'} "
          f"voxel: loss rel diff "
          f"{loss_rel:.3e} (bound {TOL_TRAIN_LOSS:g}), gradients max "
          f"|diff| / max |grad| per tensor {grad_rel:.3e} (bound "
          f"{TOL_TRAIN_GRAD:g}), BN statistics max |diff| / max |stat| per "
          f"buffer {bn_rel:.3e} (bound "
          f"{TOL_TRAIN_BN:g}); card launches {launches}")
    if not (loss_rel <= TOL_TRAIN_LOSS and grad_rel <= TOL_TRAIN_GRAD
            and bn_rel <= TOL_TRAIN_BN):
        fail("card and CPU train steps disagree")
    if launches != want:
        fail(f"the card's train step launched {launches}, not {want}")


FLOW_SOURCES = {
    "iwe_vote_fwd": ("motionpriorcmax_tpu_torch/csrc/iwe_vote.cu",
                     "motionpriorcmax_tpu/ops/pallas/iwe_vote.py:398"),
    "iwe_vote_bwd": ("motionpriorcmax_tpu_torch/csrc/iwe_vote.cu",
                     "motionpriorcmax_tpu/ops/pallas/iwe_vote.py:411"),
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
}
FLOW_WORK = {
    "iwe_vote_fwd": "one polarity half: B=14, M=2^19, 480x640, cell-sorted "
                    "(unsorted_*: the same events in random order)",
    "iwe_vote_bwd": "one polarity half: B=14, M=2^19, 480x640, cell-sorted, "
                    "no weight gradient (unsorted_*: random order)",
    "lut_gather_fwd": "B=14, M=2^20, LUT [1800, 160, 2] f32",
    "lut_segsum_bwd": "B=14, M=2^20, S=2 x 288,000 cells, C=2; replaces "
                      "the boundary gather of ops/events.py:459-464",
    "softmax_interp_fwd": "G=210, Q=N=19,200, C=2, per-bin band, f32 "
                          "(library: scaled_dot_product_attention, dense, "
                          "no band)",
    "softmax_interp_bwd": "G=210, Q=N=19,200, C=2, per-bin band, f32 "
                          "d vals",
    "voxel_vote": "B=14, M=2^20 cell-sorted events -> 14 x 15 x 480 x 640 "
                  "(unsorted_*: the same events in random order)",
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
    phase_breakdown(torch, model, requests[1], ts)
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
        "work": "one refinement iteration: levels 1-4, B=8, 384x512, f32",
    }]

    # flow-train, exact KNN and host voxel grids
    t_flow = time.perf_counter()
    fcfg, floss = flow_configs(DSEC_CONFIG)
    train_batch, val_batch = phase_flow_batch(
        fcfg, floss, DSEC_CONFIG["data"]["batch_size"])
    numbers = phase_flow_kernels(torch, fcfg, floss, train_batch)
    flow_launches = phase_flow_train(torch, fcfg, floss, train_batch,
                                     val_batch, smi_line, EXACT_STEP,
                                     EXACT_VAL)
    phase_flow_breakdown(torch, fcfg, floss, train_batch)
    torch.cuda.empty_cache()
    phase_flow_card_vs_cpu(torch)
    print(f"[done] flow-train phases {time.perf_counter() - t_flow:.1f} s")

    # flow-train, knn_method softmax and voxel grids built in the step:
    # phase 8's batches without their 'voxel'
    t_soft = time.perf_counter()
    scfg, sloss = flow_configs({**DSEC_CONFIG, "loss": {
        **DSEC_CONFIG["loss"], "knn_method": "softmax"}})
    train_batch.pop("voxel")
    val_batch.pop("voxel")
    numbers.update(phase_softmax_kernels(torch, sloss, train_batch))
    soft_launches = phase_flow_train(torch, scfg, sloss, train_batch,
                                     val_batch, smi_line, SOFTMAX_STEP,
                                     SOFTMAX_VAL, tag="softmax-train")
    del val_batch
    phase_flow_breakdown(torch, scfg, sloss, train_batch,
                         tag="softmax-breakdown")
    del train_batch
    torch.cuda.empty_cache()
    phase_flow_card_vs_cpu(torch, {"knn_method": "softmax"}, True,
                           SOFTMAX_STEP, tag="softmax-card-vs-cpu")
    print(f"[done] softmax flow-train phases "
          f"{time.perf_counter() - t_soft:.1f} s")
    for kname in FLOW_KERNELS + SOFTMAX_KERNELS:
        source, replaces = FLOW_SOURCES[kname]
        runs = soft_launches if kname in SOFTMAX_KERNELS else flow_launches
        entry = {"name": kname, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": runs[kname]}
        entry.update(numbers[kname])
        entry["work"] = FLOW_WORK[kname]
        kernels.append(entry)

    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

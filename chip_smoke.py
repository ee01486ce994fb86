#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, one or more lines each; any failure exits non-zero:
  1. environment: card name and count, nvidia-smi name and power limit, and
     the process's TF32 flags, left at torch's defaults as the CLI leaves
     them (the model's forward turns both off for compute_dtype float32)
  2. build: the corr-window kernel from motionpriorcmax_tpu_torch/csrc with
     nvcc for sm_90a, and nvcc's -Xptxas -v report
  3. kernel vs plain: the corr-window kernel against its plain PyTorch
     version at the four pyramid-level shapes of the EVIMO2 batch-8 path,
     f32 and bf16 volumes, with coordinates outside the maps
  4. timing (CUDA events, L2 flushed between launches): kernel, its memory
     bound, the plain version, and F.grid_sample (align_corners=True, zero
     padding; the reference's own sampler, never called by the port)
  5. serving: RAFT-Spline Tab2L5 at full width with seeded random weights,
     raft_validation_step on 1 warm-up + 3 synthetic B=8 384x512 requests:
     latency, samples/s, peak memory, kernel launches per request (48),
     finite metrics, and both TF32 flags off inside every forward
  6. where the time goes: CUDA events around the model's parts over 3 more
     requests with the batch on the card (feature encoder, corr volume and
     pyramid, context encoder, the 12 lookups, the 12 update blocks, the
     rest), then torch.profiler over one request: kernel time and the
     card's idle share
  7. card vs CPU: the same weights and inputs through the port on the CPU
     (plain lookup) and on the card (kernel) at the small test geometry

The line before the last is a JSON object with the kernel's numbers; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
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


def phase_env(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"[env] device={name!r} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda} process tf32 flags (torch defaults, as "
          f"the CLI leaves them): matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    print(smi_line)
    return name, count, smi_line


def phase_build():
    from motionpriorcmax_tpu_torch.ops.cuda.build import build_library

    t0 = time.perf_counter()
    path, log = build_library("corr_window")
    print(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s "
          "(nvcc -gencode arch=compute_90a,code=sm_90a)")
    for line in log.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            print(f"[build] {line.strip()}")


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


def main() -> int:
    import torch

    t_start = time.perf_counter()
    name, count, _ = phase_env(torch)
    phase_build()
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
    kernel = {
        "name": "corr_window_lookup", "route": "cuda",
        "source": "motionpriorcmax_tpu_torch/csrc/corr_window.cu",
        "replaces": "motionpriorcmax_tpu/ops/pallas/corr_window.py:101",
        "launches": launches, "max_abs_err": max_err,
        "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"], "bound_by": "bytes",
        "library_ms": totals["library_ms"],
        "work": "one refinement iteration: levels 1-4, B=8, 384x512, f32",
    }
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""RAFT-Spline benchmark at EVIMO2 scale (JAX: benchmarks/raft.py).

    python -m motionpriorcmax_tpu_torch.benchmarks.raft [--batch N]
        [--train-only] [--supervised] [--device cpu] ...

Tab2L5 (41 + 25 bins, Bezier degree 10, targets 8-40, levels
(1, 1, 1, 1, 4), 12 iterations) at 384x512 with seeded random weights
(training/raft_spline.py::create_raft_train_state, torch.Generator seed
0).  Prints a line naming the device, then JSON lines:

  raft_spline_fwd_12it_evimo2_ms       test-mode forward (eval mode)
  raft_spline_valstep_ms               raft_validation_step, 6 GT steps
  raft_spline_selfsup_trainstep_ms     raft_train_step on 2^19 cell-sorted
                                       events per sample, softmax focus
                                       loss (rows 1, 2, 3, 6 and 7)
  raft_spline_supervised_trainstep_ms  with --supervised, instead:
                                       raft_supervised_train_step (gamma
                                       0.8, 5 GT steps; rows 1 and 2)

`vs_baseline` compares a train step with the derived A6000 band of the
reference (REFERENCE_RAFT_B6_STEP_MS, per sample), as the JAX module does.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils.profiling import device_timer
from . import bench_device, device_line

# Derived A6000 band for the reference training its own Tab2L5 recipe
# (batch 6, 41+25 bins, 12 iters, CMax loss @512k ev/sample): 320-500 ms per
# step; vs_baseline compares against the CONSERVATIVE edge per sample, like
# bench.py (see BASELINE.md 'trajectory (RAFT-Spline) train step').
REFERENCE_RAFT_B6_STEP_MS = 500.0

TAB2L5 = dict(nbins_context=41, nbins_correlation=25, bezier_degree=10,
              ev_target_indices=(8, 16, 24, 32, 40), ev_levels=(1, 1, 1, 1, 4),
              iters=12)
HW = (384, 512)
EVENTS_PER_SAMPLE = 1 << 19
# (timed calls, warm-up calls) per record, the JAX module's.
CALLS = {"fwd": (5, 1), "valstep": (3, 1), "train": (8, 2)}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m motionpriorcmax_tpu_torch.benchmarks.raft",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; exits without a card) or cpu")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--train-only", action="store_true")
    ap.add_argument("--write-json", default=None,
                    help="also write the train-step JSON line to this path")
    ap.add_argument("--corr-dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--compute-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="conv compute dtype for encoders + update block "
                         "(f32 parameters, norm statistics and carry)")
    ap.add_argument("--gamma", type=float, default=None,
                    help="gamma-weighted all-iteration self-sup loss "
                         "(default: final-iteration only)")
    ap.add_argument("--gamma-sample-k", type=int, default=None,
                    help="with --gamma: unbiased subsample of K non-final "
                         "iterations per step (training/raft_spline.py)")
    ap.add_argument("--remat-encoders", action="store_true",
                    help="accepted and ignored: the port keeps every "
                         "activation, no configured batch outgrows the card")
    ap.add_argument("--remat-policy", default=None,
                    choices=(None, "dots", "dots_window"),
                    help="accepted and ignored, as --remat-encoders")
    ap.add_argument("--interp-band", default="per_group",
                    choices=("static", "dynamic", "per_group"),
                    help="CMax interp row-band mode for the self-sup loss "
                         "(FocusLossConfig.interp_band_dynamic)")
    ap.add_argument("--supervised", action="store_true",
                    help="bench the gamma-weighted supervised MultiFlow "
                         "train step instead of the self-sup CMax step")
    return ap.parse_args(argv)


def emit(rec: dict, records: List[dict]) -> None:
    print(json.dumps(rec), flush=True)
    records.append(rec)


def run(args: argparse.Namespace, device, hw=HW,
        events_per_sample: int = EVENTS_PER_SAMPLE,
        calls: Optional[Dict[str, tuple]] = None, **cfg_overrides
        ) -> List[dict]:
    """The records of `args` on `device`; `hw`, `events_per_sample`,
    `calls` ({record: (timed, warm-up)}) and RAFTSplineConfig overrides of
    Tab2L5 cut the run down (the tests)."""
    from ..data.host_ops import lut_cell_sort
    from ..losses import FocusLossConfig
    from ..models.raft_spline import RAFTSplineConfig
    from ..training.raft_spline import (RAFTTrainConfig,
                                        create_raft_train_state,
                                        raft_supervised_train_step,
                                        raft_train_step, raft_validation_step)

    dev = torch.device(device)
    calls = {**CALLS, **(calls or {})}
    print(device_line(dev), flush=True)
    cfg = RAFTSplineConfig(**{**TAB2L5, **cfg_overrides},
                           corr_dtype=args.corr_dtype,
                           compute_dtype=args.compute_dtype)
    (h, w), b = hw, args.batch
    rng = np.random.default_rng(0)

    def put(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    voxel = put(rng.normal(size=(b, cfg.nbins_total, h, w)).astype(np.float32))
    state = create_raft_train_state(cfg, RAFTTrainConfig(use_scheduler=False),
                                    dev, torch.Generator().manual_seed(0))
    model = state.model
    records: List[dict] = []

    if not args.train_only:
        def fwd(v):
            model.eval()
            with torch.no_grad():
                return model(v, test_mode=True)

        n, warm = calls["fwd"]
        dt, _ = device_timer(fwd, voxel, iters=n, warmup=warm)
        emit({"metric": "raft_spline_fwd_12it_evimo2_ms",
              "value": round(dt * 1e3, 1), "batch": b}, records)

        m = 6
        batch = {"ev_repr": voxel,
                 "flow": put(rng.normal(size=(b, m, 2, h, w))
                             .astype(np.float32)),
                 "flow_valid": put(rng.uniform(size=(b, m, h, w)) > 0.3)}
        ts = tuple(np.linspace(0, 1, m + 1)[1:].tolist())
        n, warm = calls["valstep"]
        dt, _ = device_timer(lambda bt: raft_validation_step(model, bt, ts),
                             batch, iters=n, warmup=warm)
        emit({"metric": "raft_spline_valstep_ms",
              "value": round(dt * 1e3, 1), "batch": b}, records)

    n, warm = calls["train"]
    if args.supervised:
        # The paper's MultiFlow recipe: gamma-weighted L1 over all
        # iterations.
        t_steps = 5                      # 500 ms / 100 ms GT cadence
        sbatch = {
            "ev_repr": voxel,
            "flow": put(rng.normal(size=(b, t_steps, 2, h, w))
                        .astype(np.float32)),
            "flow_timestamps": put(np.broadcast_to(
                np.linspace(0, 1, t_steps + 1)[1:].astype(np.float32),
                (b, t_steps)).copy())}
        dt, _ = device_timer(
            lambda bt: raft_supervised_train_step(state, bt)[
                "train_losses/total"], sbatch, iters=n, warmup=warm)
        rec = {"metric": "raft_spline_supervised_trainstep_ms",
               "value": round(dt * 1e3, 1), "unit": "ms", "batch": b,
               "corr_dtype": args.corr_dtype,
               "vs_baseline": round(
                   (b / 6.0) * REFERENCE_RAFT_B6_STEP_MS / (dt * 1e3), 3)}
    else:
        # Self-supervised step: 12 iterations + CMax + backward + AdamW.
        nb = cfg.nbins_context
        loss_cfg = FocusLossConfig(
            image_shape=(h, w), num_bins=nb, num_knn=32, smooth_weight=0.06,
            smooth_type="on_flow_to_next", polarity_aware_batching=False,
            knn_method="softmax", knn_block_size=512,
            interp_band_dynamic={"static": False, "dynamic": True,
                                 "per_group": "per_group"}[args.interp_band])
        m_ev = events_per_sample
        t = rng.uniform(0, 1, (b, m_ev))
        bins = np.clip((t * nb).astype(np.int32), 0, nb - 1).astype(np.float32)
        events_np = np.stack([
            rng.uniform(0, h - 1, (b, m_ev)), rng.uniform(0, w - 1, (b, m_ev)),
            t, rng.integers(0, 2, (b, m_ev)).astype(np.float32), bins,
            np.ones((b, m_ev))], -1).astype(np.float32)
        # Cell-sorted as the traj-train CLI's loader sorts them: the sorted
        # LUT gather and its segment sum, the vote's row band.
        pairs = [lut_cell_sort(e, (h, w), nb, 4) for e in events_np]
        tbatch = {"ev_repr": voxel,
                  "events": put(np.stack([p[0] for p in pairs])),
                  "lut_cell_ends": put(np.stack([p[1] for p in pairs]))}
        gen = torch.Generator().manual_seed(3)
        dt, _ = device_timer(
            lambda bt: raft_train_step(
                state, bt, gen, loss_cfg, gamma=args.gamma,
                gamma_sample_k=args.gamma_sample_k)["train_losses/total"],
            tbatch, iters=n, warmup=warm)
        rec = {"metric": "raft_spline_selfsup_trainstep_ms",
               "value": round(dt * 1e3, 1), "unit": "ms", "batch": b,
               "events": b * m_ev, "corr_dtype": args.corr_dtype,
               "compute_dtype": args.compute_dtype, "gamma": args.gamma,
               "gamma_sample_k": args.gamma_sample_k,
               "events_per_s": round(b * m_ev / dt),
               "vs_baseline": round(
                   (b / 6.0) * REFERENCE_RAFT_B6_STEP_MS / (dt * 1e3), 3)}
    emit(rec, records)
    if args.write_json:
        with open(args.write_json, "w") as fh:
            json.dump(rec, fh)
    return records


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    args = parse_args(argv)
    return run(args, bench_device(args.device, "raft"))


if __name__ == "__main__":
    main()

"""CLI subcommands of the port (JAX: cli/main.py).

traj-val: RAFT-Spline trajectory validation on EVIMO2, with the JAX CLI's
arguments, Hydra-style overrides and printout, plus --device.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def raft_config_from_tree(mc: dict):
    """RAFTSplineConfig from the composed `model` config section."""
    from ..models.raft_spline import RAFTSplineConfig

    return RAFTSplineConfig(
        nbins_context=mc["num_bins"]["context"],
        nbins_correlation=mc["num_bins"]["correlation"],
        bezier_degree=mc["bezier_degree"], curve_type=mc["curve_type"],
        detach_bezier=mc.get("detach_bezier", False),
        use_events=mc.get("use_events", True),
        use_boundary_images=mc.get("use_boundary_images", False),
        ev_target_indices=tuple(mc["correlation"]["ev"]["target_indices"]),
        ev_levels=tuple(mc["correlation"]["ev"]["levels"]),
        iters=mc["num_iter"]["test"],
        corr_dtype=mc.get("corr_dtype", "float32"),
        compute_dtype=mc.get("compute_dtype", "float32"))


def stack_traj_batch(samples: Sequence[dict], device: torch.device,
                     use_boundary_images: bool) -> Dict[str, torch.Tensor]:
    """Collate provider samples into a trajectory-validation batch on device."""
    def put(key):
        return torch.from_numpy(np.stack([s[key] for s in samples])).to(device)

    batch = {"ev_repr": put("ev_repr"), "flow": put("flow")}
    if "flow_valid" in samples[0]:
        batch["flow_valid"] = put("flow_valid")
    if use_boundary_images and "img" in samples[0]:
        batch["img"] = [
            torch.from_numpy(np.stack([s["img"][j] for s in samples])).to(device)
            for j in range(2)]
    return batch


def run_traj_validation(model, provider, bsz: int,
                        flow_timestamps: Sequence[float],
                        min_traj_len: Optional[float] = None,
                        max_traj_len: Optional[float] = None) -> dict:
    """One validation pass over `provider` (indexable samples) -> metrics.

    Full batches only, as the JAX CLI does; metric sums stay on the device
    until the end."""
    from ..metrics import MetricBank
    from ..training.raft_spline import raft_validation_step

    device = next(model.parameters()).device
    bank = MetricBank()
    n = len(provider)
    bsz = min(bsz, n)
    for i0 in range(0, n - n % bsz, bsz):
        samples = [provider[i] for i in range(i0, i0 + bsz)]
        batch = stack_traj_batch(samples, device,
                                 model.cfg.use_boundary_images)
        bank.update_device(raft_validation_step(
            model, batch, flow_timestamps, min_traj_len, max_traj_len))
    return bank.compute()


def cmd_traj_val(args) -> int:
    """Trajectory validation on EVIMO2 (reference scripts/trajectory_inference.py)."""
    from ..config import compose
    from ..data.evimo2 import Evimo2Provider
    from ..device import resolve_device
    from ..training.checkpoint import (extract_model_weights,
                                       load_raft_spline_weights)
    from ..training.raft_spline import create_raft_model

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"traj-val: {exc}") from None
    cfg_tree = compose(args.config_dir, args.config_name, args.overrides)
    cfg = raft_config_from_tree(cfg_tree["model"])

    ckpt = cfg_tree.get("checkpoint")
    if ckpt:
        # The JAX CLI runs on random weights when this path is missing; the
        # port refuses instead.
        if not Path(str(ckpt)).exists():
            raise SystemExit(f"checkpoint {ckpt} does not exist")
        if not str(ckpt).endswith((".pth", ".ckpt")):
            raise SystemExit(
                f"checkpoint {ckpt}: the port reads reference .ckpt/.pth "
                "files; orbax checkpoints of the JAX package are not readable")

    ds = cfg_tree["dataset"]
    dataset_name = ds.get("name", "evimo2")
    if dataset_name == "multiflow":
        raise SystemExit("dataset.name=multiflow is not ported yet; the port's "
                         "traj-val reads EVIMO2")
    if dataset_name != "evimo2":
        raise SystemExit(f"unknown dataset {dataset_name!r}")
    provider = Evimo2Provider(
        ds["path"], nbins_context=cfg.nbins_context,
        flow_time_ms=ds["flow_time"],
        normalize_voxel_grid=ds["normalize_voxel_grid"],
        flow_every_n_ms=ds["flow_every_n_ms"])
    num_steps = int(ds["flow_time"] // ds["flow_every_n_ms"])

    model = create_raft_model(cfg, device, torch.Generator().manual_seed(0))
    if ckpt:
        # Published reference checkpoint: Lightning RAFTSplineModule whose
        # model attribute is 'net' (src/modules/raft_spline.py:30).
        load_raft_spline_weights(model, extract_model_weights(str(ckpt),
                                                              prefix="net."))

    ts = tuple(np.linspace(0, 1, num_steps + 1)[1:].tolist())
    vc = cfg_tree.get("validation", {}) or {}
    results = run_traj_validation(model, provider,
                                  cfg_tree.get("batch_size", 8), ts,
                                  vc.get("min_traj_len"),
                                  vc.get("max_traj_len"))
    print("==========================")
    print("Validation results:")
    for key in ("val/masked_TEPE", "val/masked_TAE", "val/masked_T3PE"):
        if key in results:
            print(f"{key}: {results[key]:.4f}")
    print("==========================")
    for k in sorted(results):
        print(f"{k}: {results[k]:.5f}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="motionpriorcmax_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("traj-val", help="EVIMO2 trajectory validation")
    p.add_argument("--config-dir", required=True)
    p.add_argument("--config-name", default="val")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda fails when absent")
    p.add_argument("overrides", nargs="*")
    p.set_defaults(fn=cmd_traj_val)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

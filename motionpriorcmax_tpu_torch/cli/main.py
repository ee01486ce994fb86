"""CLI subcommands of the port (JAX: cli/main.py).

flow-train: self-supervised DSEC flow training (UNet + focus loss), with
the JAX CLI's --config / --workdir / --ckp_path / --event-capacity /
--log-every / --device-voxelize (voxel grids built inside the step from the
batch's events instead of by the loader), plus --device.
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


def flow_configs(config: dict):
    """(TrajectoryNetConfig, FocusLossConfig) from a propagated flow-training
    config; `model.unet_widths` (the port's own leaf) narrows the UNet."""
    from ..losses import make_loss
    from ..training.trajectory_net import TrajectoryNetConfig

    mc, lc = config["model"], config["loss"]
    extra = {}
    if "unet_widths" in mc:
        extra["unet_widths"] = tuple(mc["unet_widths"])
    cfg = TrajectoryNetConfig(
        image_shape=tuple(mc["image_shape"]), lr=mc["lr"],
        num_bins=mc["num_bins"], num_basis=mc["num_basis"],
        patch_size=mc["patch_size"], model_type=mc.get("model_type", "default"),
        basis_type=mc["basis_type"], skip_frames=mc.get("skip_frames", 1),
        compute_dtype=mc.get("compute_dtype", "float32"), **extra)
    loss_cfg = make_loss(lc["loss_name"], image_shape=tuple(lc["image_shape"]),
                         **{k: v for k, v in lc.items()
                            if k not in ("loss_name", "image_shape")})
    return cfg, loss_cfg


def cmd_flow_train(args) -> int:
    """Self-supervised DSEC flow training (reference scripts/flow_training.py)."""
    from datetime import datetime

    from ..config import load_yaml, propagate_config
    from ..data.dsec import DsecDatasetProvider
    from ..data.loader import DataLoader
    from ..device import resolve_device
    from ..training.checkpoint import restore_checkpoint
    from ..training.loop import train_flow
    from ..training.trajectory_net import create_train_state

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"flow-train: {exc}") from None
    config = propagate_config(load_yaml(args.config))
    cfg, loss_cfg = flow_configs(config)
    dc = config["data"]
    pab = dc.get("polarity_aware_batching", False)
    capacity = args.event_capacity
    pos_capacity = capacity // 2 if pab else None

    def make_loader(split, shuffle):
        provider = DsecDatasetProvider(
            dc["data_path"], split=split, num_bins=dc["num_bins"],
            polarity_aware_batching=pab,
            host_voxelize=not args.device_voxelize,
            voxel_norm_type=dc.get("norm_type", "mean_std"),
            voxel_quantile=dc.get("quantile", 0.0))
        return DataLoader(provider, batch_size=dc["batch_size"],
                          capacity=capacity, shuffle=shuffle,
                          num_workers=dc.get("num_workers", 8),
                          polarity_aware=pab, pos_capacity=pos_capacity,
                          lut_cell_sort_params=(
                              loss_cfg.image_shape, loss_cfg.num_bins,
                              loss_cfg.lut_superpixel_size))

    resume_state = None
    if args.ckp_path:
        resume_state, step = restore_checkpoint(
            args.ckp_path, create_train_state(cfg, device))
        print(f"resumed from {args.ckp_path} @ step {step}")
    workdir = args.workdir or f"runs/flow_{datetime.now():%Y%m%d_%H%M%S}"
    out = train_flow(cfg, loss_cfg, make_loader("train", True),
                     make_loader("val", False), workdir, device=device,
                     max_epochs=config.get("trainer", {}).get("max_epochs", 100),
                     num_pos_events=pos_capacity if pab else -1,
                     resume_state=resume_state, log_every=args.log_every)
    print(f"done: best={out['best']:.4f} steps={out['steps']}")
    return 0


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

    p = sub.add_parser("flow-train", help="self-supervised DSEC flow training")
    p.add_argument("--config", required=True)
    p.add_argument("--workdir", default=None)
    p.add_argument("--ckp_path", "--ckp-path", dest="ckp_path", default=None,
                   help="a checkpoint directory of this port's flow-train")
    p.add_argument("--event-capacity", type=int, default=1 << 20)
    p.add_argument("--log-every", type=int, default=200)
    p.add_argument("--device-voxelize", action="store_true",
                   help="voxelize the batch's (capacity-truncated) events "
                        "inside the step, on the device, instead of every "
                        "event of the window in the loader")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda fails when absent")
    p.set_defaults(fn=cmd_flow_train)

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

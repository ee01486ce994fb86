"""CLI subcommands of the port (JAX: cli/main.py).

flow-train: self-supervised DSEC flow training (UNet + focus loss), with
the JAX CLI's --config / --workdir / --ckp_path / --event-capacity /
--event-capacity-buckets / --log-every / --device-voxelize (voxel grids
built inside the step from the batch's events instead of by the loader)
/ --mesh / --coordinator / --num-processes / --process-id, plus --device;
each epoch writes the image panel of five val samples under
<workdir>/images/.
dsec-infer: DSEC benchmark-submission PNGs of the seven test sequences,
with the JAX CLI's --config / --timestamp-dir / --ckpt-step, plus --device.
extract-weights: a checkpoint -> bare weights .npz that dsec-infer reads.
traj-val: RAFT-Spline trajectory validation on EVIMO2 or MultiFlow, with
the JAX CLI's arguments, Hydra-style overrides and printout, plus --device.
traj-train: RAFT-Spline training, self-supervised or supervised, with the
JAX CLI's arguments, plus --device.

flow-train and traj-train run as one process per rank: each runs the same
command with its own --process-id, the same --coordinator host:port and
--num-processes, over NCCL with one card per rank (--device cuda) or gloo
on the CPU.  --mesh DATA,EVENT lays the ranks out (default: gcd(batch,
ranks), 1, which must use every rank); each step then makes the
single-device step of the global batch (parallel/mesh.py).
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


def parse_mesh(value: str):
    """--mesh: DATA,EVENT, two positive integers (JAX: _parse_mesh)."""
    parts = value.split(",")
    try:
        if len(parts) != 2:
            raise ValueError
        data, event = (int(p) for p in parts)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected DATA,EVENT axis sizes, got {value!r}") from None
    if data <= 0 or event <= 0:
        raise argparse.ArgumentTypeError("mesh axis sizes must be positive")
    return (data, event)


def _add_process_args(p) -> None:
    """flow-train's and traj-train's multi-process flags."""
    p.add_argument("--mesh", default=None, type=parse_mesh,
                   help="DATA,EVENT mesh axis sizes (default: "
                        "gcd(batch, ranks),1; DATA x EVENT must be the "
                        "number of processes)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0's process-group store (run "
                        "this command once per rank)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


def join_processes(args, cmd: str):
    """This process's device, after joining the process group when the
    multi-process flags ask for one (parallel.initialize_distributed);
    exits when the device is absent or the flags are incomplete."""
    from ..parallel import initialize_distributed

    try:
        return initialize_distributed(args.coordinator, args.num_processes,
                                      args.process_id, device=args.device)
    except (RuntimeError, ValueError) as exc:
        raise SystemExit(f"{cmd}: {exc}") from None


def cli_mesh(args, batch_size: int, cmd: str):
    """(mesh, train shard, val shard): None, None, None without a process
    group; else --mesh, by default (gcd(batch, ranks), 1) as in the JAX
    CLI, the data rank's train shard and the rank's own val shard.  Exits
    when the mesh leaves a rank idle or does not split the batch, and when
    --event-capacity-buckets meets several processes."""
    import math

    import torch.distributed as dist

    from ..parallel import make_mesh

    if not dist.is_initialized():
        if args.mesh not in (None, (1, 1)):
            raise SystemExit(f"{cmd}: --mesh {args.mesh} needs "
                             "--num-processes and --coordinator")
        return None, None, None
    world = dist.get_world_size()
    if world > 1 and getattr(args, "event_capacity_buckets", None):
        raise SystemExit(f"{cmd}: --event-capacity-buckets is single-process "
                         "only (one static capacity across ranks)")
    data, event = args.mesh or (math.gcd(batch_size, world), 1)
    if batch_size % data:
        raise SystemExit(f"{cmd}: batch {batch_size} does not split over "
                         f"{data} data ranks")
    try:
        mesh = make_mesh(data, event)
    except ValueError as exc:
        raise SystemExit(f"{cmd}: {exc}") from None
    return mesh, (mesh.data_index, mesh.data), (mesh.rank, mesh.world)


def cmd_flow_train(args) -> int:
    """Self-supervised DSEC flow training (reference scripts/flow_training.py)."""
    from datetime import datetime

    from ..config import load_yaml, propagate_config
    from ..data.dsec import DsecDatasetProvider
    from ..data.loader import DataLoader
    from ..training.checkpoint import restore_checkpoint
    from ..training.loop import train_flow
    from ..training.trajectory_net import create_train_state

    device = join_processes(args, "flow-train")
    config = propagate_config(load_yaml(args.config))
    cfg, loss_cfg = flow_configs(config)
    dc = config["data"]
    mesh, train_shard, val_shard = cli_mesh(args, dc["batch_size"],
                                            "flow-train")
    is_main = mesh is None or mesh.is_main
    pab = dc.get("polarity_aware_batching", False)
    capacity = args.event_capacity
    pos_capacity = capacity // 2 if pab else None

    def make_loader(split, shuffle, shard):
        provider = DsecDatasetProvider(
            dc["data_path"], split=split, num_bins=dc["num_bins"],
            polarity_aware_batching=pab,
            host_voxelize=not args.device_voxelize,
            voxel_norm_type=dc.get("norm_type", "mean_std"),
            voxel_quantile=dc.get("quantile", 0.0))
        return DataLoader(provider,
                          batch_size=dc["batch_size"] // (mesh.data if mesh
                                                          else 1),
                          capacity=capacity, shuffle=shuffle, shard=shard,
                          equal_batches=split == "train",
                          num_workers=dc.get("num_workers", 8),
                          polarity_aware=pab, pos_capacity=pos_capacity,
                          capacity_buckets=args.event_capacity_buckets,
                          lut_cell_sort_params=(
                              loss_cfg.image_shape, loss_cfg.num_bins,
                              loss_cfg.lut_superpixel_size),
                          pin_memory=device.type == "cuda")

    resume_state = None
    if args.ckp_path:
        resume_state, step = restore_checkpoint(
            args.ckp_path, create_train_state(cfg, device))
        if is_main:
            print(f"resumed from {args.ckp_path} @ step {step}")
    workdir = args.workdir or f"runs/flow_{datetime.now():%Y%m%d_%H%M%S}"
    val_loader = make_loader("val", False, val_shard)
    # The epoch's image panel: val samples, each collated as the val
    # loader collates a batch.
    out = train_flow(cfg, loss_cfg, make_loader("train", True, train_shard),
                     val_loader, workdir, device=device,
                     max_epochs=config.get("trainer", {}).get("max_epochs", 100),
                     num_pos_events=pos_capacity if pab else -1,
                     resume_state=resume_state, log_every=args.log_every,
                     image_log_dataset=val_loader.dataset,
                     image_log_collate=val_loader.collate, mesh=mesh)
    print(f"done: best={out['best']:.4f} steps={out['steps']}")
    return 0


MAX_FLOW_PX = 60      # the DSEC benchmark's magnitude cap


def infer_config(config: dict):
    """The TrajectoryNetConfig of a propagated dsec_inference.yaml-style
    config (its loss section a stub when it has none, as JAX's)."""
    cfg, _ = flow_configs({**config, "loss": config.get("loss", {
        "loss_name": "FOCUS", "image_shape": config["model"]["image_shape"]})})
    return cfg


def infer_window(state, cfg, events: np.ndarray, norm_type: Optional[str],
                 device: torch.device) -> np.ndarray:
    """Dense flow [2, H, W] f32 on the host of one window's packed [N, 5]
    events (y, x, t, p, bin): the events as [1, N, 6] rows with valid = 1
    on `device`, one voxel vote (the voxel-vote kernel on the card),
    `normalize_voxel_grid` with `norm_type`, then `predict_flow`."""
    from ..ops.events import normalize_voxel_grid, voxel_grid_from_events
    from ..training.trajectory_net import predict_flow

    h, w = cfg.image_shape
    packed = torch.from_numpy(events).to(device)
    rows = torch.cat([packed, torch.ones_like(packed[:, :1])], 1)[None]
    with torch.no_grad():
        voxel = voxel_grid_from_events(rows, num_bins=cfg.num_bins,
                                       height=h, width=w)
        voxel = normalize_voxel_grid(voxel, norm_type)
    return predict_flow(state, voxel, cfg)[0].cpu().numpy()


def infer_sequence(state, cfg, seq, out_dir: Path, norm_type: Optional[str],
                   device: torch.device) -> int:
    """Flow PNGs of every window of `seq` (a test-phase DsecSequence) under
    `out_dir`, named <file_index:06d>.png; returns the window count.

    Per window: the sample (events rectified and packed), `infer_window`,
    the 60 px cap and the 16-bit PNG."""
    from ..utils.flow_io import save_flow_png, scale_optical_flow

    out_dir.mkdir(parents=True, exist_ok=True)
    for i in range(len(seq)):
        sample = seq[i]
        flow = infer_window(state, cfg, sample["events"], norm_type, device)
        save_flow_png(out_dir / f"{int(sample['file_index']):06d}.png",
                      scale_optical_flow(flow, MAX_FLOW_PX))
    return len(seq)


def cmd_dsec_infer(args) -> int:
    """DSEC benchmark-submission inference (reference
    scripts/dsec_inference.py): the UNet's weights from a reference .pth /
    .ckpt, an .npz of either layout or a flow-train checkpoint directory;
    the test sequences of the timestamp CSVs; 16-bit PNGs with the 60 px
    magnitude cap under <output_dir>/<date_time>/flow/<sequence>/."""
    from datetime import datetime

    from ..config import load_yaml, propagate_config
    from ..data.dsec import DsecSequence
    from ..device import resolve_device
    from ..training.checkpoint import load_flow_model_weights
    from ..training.trajectory_net import create_train_state

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"dsec-infer: {exc}") from None
    config = propagate_config(load_yaml(args.config))
    cfg = infer_config(config)
    state = create_train_state(cfg, device)
    ckpt_path = config["model"]["ckpt_path"]
    try:
        loaded = load_flow_model_weights(state.model, str(ckpt_path),
                                         args.ckpt_step)
    except (ValueError, FileNotFoundError) as exc:
        raise SystemExit(f"dsec-infer: {exc}") from None
    print(f"loaded {loaded}")

    timestamp_dir = Path(args.timestamp_dir)
    test_seqs = sorted(p.stem for p in timestamp_dir.glob("*.csv"))
    dataset_dir = Path(config["data"]["root_dir"]) / "test"
    run_out = Path(config["output_dir"]) / f"{datetime.now():%Y%m%d_%H%M%S}"
    norm_type = config["data"].get("norm_type", "mean_std")
    for seq_name in test_seqs:
        seq = DsecSequence(dataset_dir / seq_name, "test", cfg.num_bins,
                           timestamp_path=str(timestamp_dir
                                              / f"{seq_name}.csv"))
        out_dir = run_out / "flow" / seq_name
        n = infer_sequence(state, cfg, seq, out_dir, norm_type, device)
        print(f"{seq_name}: {n} flow maps -> {out_dir}")
    print("Done.")
    return 0


def cmd_extract_weights(args) -> int:
    """Checkpoint -> bare weights .npz in the torch-key layout (the
    reference UNet's names, which both packages' dsec-infer read): a
    flow-train checkpoint directory (its best-metric step, else the
    latest), or a Lightning .ckpt / .pth with 'model.' stripped (reference
    scripts/extract_weights_from_checkpoint.py)."""
    from ..training.checkpoint import (checkpoint_model_state,
                                       extract_model_weights,
                                       find_checkpoint_dir,
                                       flow_model_torch_keys)

    if Path(args.ckpt).is_dir():
        ckpt_dir = find_checkpoint_dir(args.ckpt)
        if ckpt_dir is None:
            raise SystemExit(
                f"extract-weights: {args.ckpt!r} holds no checkpoint of "
                "flow-train (index.json and step_*.pt)")
        state, step = checkpoint_model_state(str(ckpt_dir), best=True)
        weights = flow_model_torch_keys(state)
        print(f"extracted step {step}")
    else:
        weights = extract_model_weights(args.ckpt)
    np.savez(args.out, **{k: v.cpu().numpy() for k, v in weights.items()})
    print(f"wrote {len(weights)} arrays -> {args.out}")
    return 0


def parse_buckets(value: str):
    """--event-capacity-buckets: comma-separated positive ascending ints."""
    try:
        buckets = tuple(int(b) for b in value.split(","))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected comma-separated integers, got {value!r}")
    if not buckets or any(b <= 0 for b in buckets) or \
            list(buckets) != sorted(buckets):
        raise argparse.ArgumentTypeError(
            f"buckets must be positive and ascending, got {value!r}")
    return buckets


def raft_config_from_tree(mc: dict, phase: str = "test"):
    """RAFTSplineConfig from the composed `model` config section, with the
    iteration count of `phase` ('test' or 'train', model.num_iter)."""
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
        img_levels=mc["correlation"].get("img", {}).get("levels", 4),
        iters=mc["num_iter"][phase],
        freeze_bn=mc.get("freeze_bn", False),
        corr_dtype=mc.get("corr_dtype", "float32"),
        compute_dtype=mc.get("compute_dtype", "float32"))


def traj_train_configs(cfg_tree: dict, image_hw, max_steps: int):
    """(RAFTSplineConfig, RAFTTrainConfig, FocusLossConfig) of traj-train
    from the composed config: the model with model.num_iter.train
    iterations, the optimizer over `max_steps` steps, and the loss at the
    data's resolution with the per-group dynamic interpolation band unless
    the config sets one (Bezier displacements have no fixed bound)."""
    from ..losses import make_loss
    from ..training.raft_spline import RAFTTrainConfig

    cfg = raft_config_from_tree(cfg_tree["model"], "train")
    tcfg = cfg_tree["training"]
    tc = RAFTTrainConfig(learning_rate=tcfg["learning_rate"],
                         weight_decay=tcfg["weight_decay"],
                         use_scheduler=tcfg["lr_scheduler"]["use"],
                         total_steps=max_steps,
                         accumulate_steps=tcfg.get("accumulate_steps", 1))
    lc = dict(cfg_tree["loss"])
    lc.setdefault("interp_band_dynamic", "per_group")
    loss_cfg = make_loss(lc.pop("type", "FOCUS"), image_shape=tuple(image_hw),
                         **lc)
    return cfg, tc, loss_cfg


def multiflow_subset(ds: dict, split: str, nbins_context: int, **kw):
    """The MultiFlow reader of `split` ('train' / 'test') under dataset.path."""
    from ..data.multiflow import MultiflowDatasubset

    return MultiflowDatasubset(
        Path(ds["path"]) / split, num_bins_context=nbins_context,
        flow_every_n_ms=ds["flow_every_n_ms"],
        prediction_time_ms=ds.get("prediction_time", 500), **kw)


def multiflow_eval_subset(ds: dict, nbins_context: int):
    """MultiFlow's test split as traj-val and traj-train validate on it."""
    return multiflow_subset(
        ds, "test", nbins_context,
        load_voxel_grid=ds.get("load_voxel_grid", True),
        extended_voxel_grid=ds.get("extended_voxel_grid", True),
        normalize_voxel_grid=ds.get("normalize_voxel_grid", True))


def stack_traj_batch(samples: Sequence[dict], device: torch.device,
                     use_boundary_images: bool) -> Dict[str, torch.Tensor]:
    """Collate provider samples into a trajectory-validation batch on device."""
    from ..utils import profiling

    def put(arrays):
        with profiling.scope("batch.stack"):
            host = torch.from_numpy(np.stack(arrays))
        profiling.count_h2d(host, device)
        with profiling.scope("batch.h2d"):
            return host.to(device)

    batch = {"ev_repr": put([s["ev_repr"] for s in samples]),
             "flow": put([s["flow"] for s in samples])}
    if "flow_valid" in samples[0]:
        batch["flow_valid"] = put([s["flow_valid"] for s in samples])
    if use_boundary_images and "img" in samples[0]:
        # [B, 2, 3, H, W], as collate.stack_samples stacks it.
        batch["img"] = put([np.stack(s["img"]) for s in samples])
    return batch


def run_traj_validation(model, provider, bsz: int,
                        flow_timestamps: Sequence[float],
                        min_traj_len: Optional[float] = None,
                        max_traj_len: Optional[float] = None,
                        iters: Optional[int] = None,
                        shard: Optional[tuple] = None) -> dict:
    """One validation pass over `provider` (indexable samples) -> metrics,
    with `iters` refinement iterations (the model's own when None).

    Full batches only, as the JAX CLI does; metric sums stay on the device
    until the end.  `shard=(rank, world)` validates every world-th sample
    from `rank` on and sums the metric sums over the process group's
    ranks (MetricBank.reduce_across_processes)."""
    from ..metrics import MetricBank
    from ..training.raft_spline import raft_validation_step

    device = next(model.parameters()).device
    bank = MetricBank()
    idx = list(range(len(provider)))
    if shard is not None:
        idx = idx[shard[0]::shard[1]]
    n = len(idx)
    bsz = max(1, min(bsz, n))
    for i0 in range(0, n - n % bsz, bsz):
        samples = [provider[i] for i in idx[i0:i0 + bsz]]
        batch = stack_traj_batch(samples, device,
                                 model.cfg.use_boundary_images)
        bank.update_device(raft_validation_step(
            model, batch, flow_timestamps, min_traj_len, max_traj_len, iters))
    if shard is not None:
        bank = bank.reduce_across_processes()
    return bank.compute()


def cmd_traj_val(args) -> int:
    """Trajectory validation on EVIMO2 (reference scripts/trajectory_inference.py)."""
    from ..config import compose
    from ..data.evimo2 import Evimo2Provider
    from ..device import resolve_device
    from ..training.checkpoint import (extract_model_weights,
                                       find_checkpoint_dir,
                                       load_raft_spline_weights,
                                       restore_model_weights)
    from ..training.raft_spline import create_raft_model

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"traj-val: {exc}") from None
    cfg_tree = compose(args.config_dir, args.config_name, args.overrides)
    cfg = raft_config_from_tree(cfg_tree["model"])

    ckpt = cfg_tree.get("checkpoint")
    ckpt_dir = None
    if ckpt:
        # The JAX CLI runs on random weights when this path is missing; the
        # port refuses instead.
        if not Path(str(ckpt)).exists():
            raise SystemExit(f"checkpoint {ckpt} does not exist")
        if Path(str(ckpt)).is_dir():
            # The port's traj-train output: its checkpoints/ or the workdir.
            ckpt_dir = find_checkpoint_dir(str(ckpt))
            if ckpt_dir is None:
                raise SystemExit(
                    f"checkpoint {ckpt}: no index.json and step_*.pt of the "
                    "port's traj-train here or in its checkpoints/; orbax "
                    "checkpoints of the JAX package are not readable")
        elif not str(ckpt).endswith((".pth", ".ckpt")):
            raise SystemExit(
                f"checkpoint {ckpt}: the port reads reference .ckpt/.pth "
                "files and its own traj-train checkpoint directories")

    ds = cfg_tree["dataset"]
    dataset_name = ds.get("name", "evimo2")
    if dataset_name == "evimo2":
        provider = Evimo2Provider(
            ds["path"], nbins_context=cfg.nbins_context,
            flow_time_ms=ds["flow_time"],
            normalize_voxel_grid=ds["normalize_voxel_grid"],
            flow_every_n_ms=ds["flow_every_n_ms"])
        num_steps = int(ds["flow_time"] // ds["flow_every_n_ms"])
        ts = tuple(np.linspace(0, 1, num_steps + 1)[1:].tolist())
    elif dataset_name == "multiflow":
        provider = multiflow_eval_subset(ds, cfg.nbins_context)
        ts = tuple(float(t) for t in provider[0]["flow_timestamps"])
    else:
        raise SystemExit(f"unknown dataset {dataset_name!r}")

    model = create_raft_model(cfg, device, torch.Generator().manual_seed(0))
    if ckpt_dir is not None:
        # The latest step, as JAX restore_checkpoint(step=None) picks it.
        restore_model_weights(str(ckpt_dir), model)
    elif ckpt:
        # Published reference checkpoint: Lightning RAFTSplineModule whose
        # model attribute is 'net' (src/modules/raft_spline.py:30).
        load_raft_spline_weights(model, extract_model_weights(str(ckpt),
                                                              prefix="net."))

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


def cmd_traj_train(args) -> int:
    """RAFT-Spline training on one device (JAX: cli/main.py cmd_traj_train):
    self-supervised (focus loss on raw events, EVIMO2 imo/train or
    MultiFlow train) or supervised (gamma-weighted L1 against MultiFlow's
    GT flow), validating on the eval split every --val-every steps."""
    import functools
    from datetime import datetime

    from ..config import compose
    from ..data.evimo2 import Evimo2Provider
    from ..data.loader import DataLoader
    from ..training.loop import train_traj
    from ..training.raft_spline import create_raft_train_state

    device = join_processes(args, "traj-train")
    cfg_tree = compose(args.config_dir, args.config_name, args.overrides)
    ds, tcfg = cfg_tree["dataset"], cfg_tree["training"]
    mesh, train_shard, val_shard = cli_mesh(args, tcfg["batch_size"],
                                            "traj-train")
    nbins_context = cfg_tree["model"]["num_bins"]["context"]
    supervised = args.loss == "supervised"
    pab = (cfg_tree["loss"].get("polarity_aware_batching", False)
           and not supervised)

    if ds.get("name") == "multiflow":
        from ..data.augment import (MultiflowAugmentor, PhotometricAugmentor,
                                    SpatialAugmentor)

        aug = None
        if ds.get("spatial_augm") or ds.get("photo_augm"):
            aug = MultiflowAugmentor(
                spatial=(SpatialAugmentor(h_flip_prob=0.5)
                         if ds.get("spatial_augm") else None),
                photometric=(PhotometricAugmentor()
                             if ds.get("photo_augm") else None))
        dataset = multiflow_subset(
            ds, "train", nbins_context,
            normalize_voxel_grid=ds["normalize_voxel_grid"],
            provide_raw_events=not supervised, polarity_aware_batching=pab,
            augmentor=aug)
    elif supervised:
        raise SystemExit("traj-train: --loss supervised needs the multiflow "
                         "dataset (EVIMO2's GT is validation-only)")
    else:
        try:
            dataset = Evimo2Provider(
                ds["path"], nbins_context, ds["flow_time"],
                ds["normalize_voxel_grid"], ds["flow_every_n_ms"],
                provide_raw_events=True, polarity_aware_batching=pab,
                split="train")
        except FileNotFoundError as exc:
            raise SystemExit(f"traj-train: {exc}") from None

    capacity = args.event_capacity
    pos_capacity = capacity // 2 if pab else None
    # The resolution comes from the data (EVIMO2 resizes to 384x512,
    # MultiFlow is 384x512).
    image_hw = tuple(dataset[0]["ev_repr"].shape[-2:])
    cfg, tc, loss_cfg = traj_train_configs(cfg_tree, image_hw, args.max_steps)
    loader = DataLoader(
        dataset, batch_size=tcfg["batch_size"] // (mesh.data if mesh else 1),
        capacity=capacity, shard=train_shard,
        polarity_aware=pab, pos_capacity=pos_capacity,
        num_workers=cfg_tree.get("hardware", {}).get("num_workers", 8),
        lut_cell_sort_params=None if supervised else (
            loss_cfg.image_shape, loss_cfg.num_bins,
            loss_cfg.lut_superpixel_size),
        pin_memory=device.type == "cuda")

    validate = None
    if args.val_every > 0:
        val_provider = None
        if ds.get("name") == "multiflow":
            if (Path(ds["path"]) / "test").is_dir():
                val_provider = multiflow_eval_subset(ds, nbins_context)
                val_ts = tuple(float(t)
                               for t in val_provider[0]["flow_timestamps"])
        elif (Path(ds["path"]) / "imo" / "eval").is_dir():
            val_provider = Evimo2Provider(
                ds["path"], nbins_context=nbins_context,
                flow_time_ms=ds["flow_time"],
                normalize_voxel_grid=ds["normalize_voxel_grid"],
                flow_every_n_ms=ds["flow_every_n_ms"])
            m = int(ds["flow_time"] // ds["flow_every_n_ms"])
            val_ts = tuple(np.linspace(0, 1, m + 1)[1:].tolist())
        if val_provider is not None:
            vc = cfg_tree.get("validation", {}) or {}
            validate = functools.partial(
                run_traj_validation, provider=val_provider,
                bsz=args.val_batch_size, flow_timestamps=val_ts,
                min_traj_len=vc.get("min_traj_len"),
                max_traj_len=vc.get("max_traj_len"),
                iters=cfg_tree["model"]["num_iter"]["test"], shard=val_shard)

    state = create_raft_train_state(cfg, tc, device,
                                    torch.Generator().manual_seed(0))
    workdir = args.workdir or f"runs/traj_{datetime.now():%Y%m%d_%H%M%S}"
    out = train_traj(state, loader, workdir, max_steps=args.max_steps,
                     loss_cfg=None if supervised else loss_cfg,
                     num_pos_events=pos_capacity if pab else -1,
                     gamma=tcfg.get("gamma"),
                     gamma_sample_k=tcfg.get("gamma_sample_k"),
                     log_every=args.log_every, ckpt_every=args.ckpt_every,
                     val_every=args.val_every, validate=validate, mesh=mesh)
    print(f"done: {out['steps']} steps -> {workdir}")
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
    p.add_argument("--event-capacity-buckets", default=None,
                   type=parse_buckets,
                   help="comma-separated ascending capacities; a batch pads "
                        "to the smallest one covering its largest sample "
                        "(per polarity half, at half the bucket) instead of "
                        "always --event-capacity")
    p.add_argument("--log-every", type=int, default=200)
    p.add_argument("--device-voxelize", action="store_true",
                   help="voxelize the batch's (capacity-truncated) events "
                        "inside the step, on the device, instead of every "
                        "event of the window in the loader")
    _add_process_args(p)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda fails when absent")
    p.set_defaults(fn=cmd_flow_train)

    p = sub.add_parser("dsec-infer", help="DSEC benchmark PNG inference")
    p.add_argument("--config", required=True)
    p.add_argument("--timestamp-dir",
                   default="config/misc/dsec_test_timestamps")
    p.add_argument("--ckpt-step", type=int, default=None,
                   help="step of a flow-train checkpoint directory (default: "
                        "the best-metric retained one, else the latest)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda fails when absent")
    p.set_defaults(fn=cmd_dsec_infer)

    p = sub.add_parser("traj-val", help="EVIMO2 trajectory validation")
    p.add_argument("--config-dir", required=True)
    p.add_argument("--config-name", default="val")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda fails when absent")
    p.add_argument("overrides", nargs="*")
    p.set_defaults(fn=cmd_traj_val)

    p = sub.add_parser("traj-train", help="RAFT-Spline trajectory training")
    p.add_argument("--config-dir", required=True)
    p.add_argument("--config-name", default="val")
    p.add_argument("--workdir", default=None)
    p.add_argument("--max-steps", type=int, default=100000)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--ckpt-every", type=int, default=1000)
    p.add_argument("--event-capacity", type=int, default=1 << 20)
    p.add_argument("--loss", choices=("selfsup", "supervised"),
                   default="selfsup",
                   help="selfsup = focus loss on raw events (EVIMO2 or "
                        "MultiFlow); supervised = gamma-weighted L1 against "
                        "GT multi-step flow (MultiFlow only)")
    p.add_argument("--val-every", type=int, default=1000,
                   help="validation + best-k checkpoints every N steps (0 "
                        "disables; needs an eval split on disk)")
    p.add_argument("--val-batch-size", type=int, default=4)
    _add_process_args(p)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda fails when absent")
    p.add_argument("overrides", nargs="*")
    p.set_defaults(fn=cmd_traj_train)

    p = sub.add_parser("extract-weights", help="ckpt -> bare weights npz")
    p.add_argument("ckpt")
    p.add_argument("out")
    p.set_defaults(fn=cmd_extract_weights)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())

"""Masked flow metrics, trajectory metrics and the metric bank
(JAX: metrics/core.py).

Every metric is a (value, weight) pair of tensors: weight 0 marks an update
whose mask was empty, so nothing leaves the device until the bank is read.
Multi-step inputs are stacked tensors [M, N, ...].
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from ..ops.flow_error import calculate_flow_error

Pair = Tuple[torch.Tensor, torch.Tensor]


def _masked_mean(values: torch.Tensor, mask: Optional[torch.Tensor]) -> Pair:
    """(mean over mask, weight) with weight 0 when the mask is empty."""
    if mask is None:
        return values.mean(), torch.ones((), dtype=values.dtype,
                                         device=values.device)
    m = mask.to(values.dtype)
    denom = m.sum()
    val = torch.where(denom > 0, (values * m).sum() / denom.clamp(min=1.0),
                      torch.zeros_like(denom))
    return val, (denom > 0).to(values.dtype)


def epe_masked(source: torch.Tensor, target: torch.Tensor,
               valid_mask: Optional[torch.Tensor] = None) -> Pair:
    """EPE over valid pixels.  source/target [N, C, ...]; mask [N, ...]."""
    epe = torch.sqrt(torch.sum((source - target) ** 2, dim=1))
    return _masked_mean(epe, valid_mask)


def ae_masked(source: torch.Tensor, target: torch.Tensor,
              valid_mask: Optional[torch.Tensor] = None,
              degrees: bool = True) -> Pair:
    """Middlebury 3-vector angular error."""
    ones = torch.ones_like(source[:, :1])
    s_ext = torch.cat([source, ones], dim=1)
    t_ext = torch.cat([target, ones], dim=1)
    nom = torch.sum(s_ext * t_ext, dim=1)
    den = (torch.linalg.vector_norm(s_ext, dim=1)
           * torch.linalg.vector_norm(t_ext, dim=1))
    ae = torch.arccos((nom / den).clamp(-1.0, 1.0))
    if degrees:
        ae = ae / math.pi * 180.0
    return _masked_mean(ae, valid_mask)


def n_pixel_error_masked(source: torch.Tensor, target: torch.Tensor,
                         valid_mask: Optional[torch.Tensor],
                         n_pixels: float) -> Pair:
    """% of valid pixels with error > n px AND relative error >= 5%."""
    gt_magn = torch.linalg.vector_norm(target, dim=1)
    err_magn = torch.linalg.vector_norm(source - target, dim=1)
    rel = err_magn / gt_magn.clamp(min=1e-6)
    err_map = ((err_magn > n_pixels) & (rel >= 0.05)).to(source.dtype)
    val, wgt = _masked_mean(err_map, valid_mask)
    return val * 100.0, wgt


def compute_traj_len(target: torch.Tensor) -> torch.Tensor:
    """GT arc length over steps: [M, N, 2, H, W] -> [N, H, W]."""
    diff = target[1:] - target[:-1]
    return torch.sqrt(torch.sum(diff ** 2, dim=2)).sum(dim=0)


def traj_len_filter_mask(target: torch.Tensor,
                         valid_mask: Optional[torch.Tensor],
                         min_traj_len: Optional[float] = None,
                         max_traj_len: Optional[float] = None
                         ) -> Optional[torch.Tensor]:
    """Intersect a [M, N, ...] validity mask with a GT-arc-length gate; with
    no mask the gate itself becomes the per-step mask; with no gate the mask
    is returned as it is."""
    if min_traj_len is None and max_traj_len is None:
        return valid_mask
    traj_len = compute_traj_len(target)
    valid_len = torch.ones_like(traj_len, dtype=torch.bool)
    if min_traj_len is not None:
        valid_len &= traj_len >= min_traj_len
    if max_traj_len is not None:
        valid_len &= traj_len <= max_traj_len
    gate = valid_len[None].expand((target.shape[0],) + tuple(valid_len.shape))
    if valid_mask is None:
        return gate
    return valid_mask & gate


def epe_masked_multi(source: torch.Tensor, target: torch.Tensor,
                     valid_mask: Optional[torch.Tensor] = None,
                     min_traj_len: Optional[float] = None,
                     max_traj_len: Optional[float] = None) -> Pair:
    """Mean of per-step masked EPE over the step axis; steps with an empty
    mask are left out of the mean."""
    valid_mask = traj_len_filter_mask(target, valid_mask, min_traj_len,
                                      max_traj_len)
    pairs = [epe_masked(source[i], target[i],
                        None if valid_mask is None else valid_mask[i])
             for i in range(source.shape[0])]
    vals = torch.stack([v for v, _ in pairs])
    wgts = torch.stack([w for _, w in pairs])
    denom = wgts.sum()
    val = torch.where(denom > 0, (vals * wgts).sum() / denom.clamp(min=1.0),
                      torch.zeros_like(denom))
    return val, (denom > 0).to(vals.dtype)


def ae_masked_multi(source: torch.Tensor, target: torch.Tensor,
                    valid_mask: Optional[torch.Tensor] = None,
                    degrees: bool = True) -> Pair:
    """Mean of per-step AE over the M steps."""
    vals = [ae_masked(source[i], target[i],
                      None if valid_mask is None else valid_mask[i], degrees)[0]
            for i in range(source.shape[0])]
    v = torch.stack(vals).mean()
    return v, torch.ones_like(v)


def trajectory_flow_metrics(source: torch.Tensor, target: torch.Tensor,
                            valid_mask: Optional[torch.Tensor] = None,
                            min_traj_len: Optional[float] = None,
                            max_traj_len: Optional[float] = None
                            ) -> Dict[str, torch.Tensor]:
    """TEPE / TAE / T3PE over the flattened step axis + per-step EPE.

    source, target [M, N, 2, H, W]; valid_mask [M, N, H, W] or None.
    """
    valid_mask = traj_len_filter_mask(target, valid_mask, min_traj_len,
                                      max_traj_len)
    m = source.shape[0]
    src_flat = source.reshape((-1,) + tuple(source.shape[2:]))
    tgt_flat = target.reshape((-1,) + tuple(target.shape[2:]))
    mask_flat = None if valid_mask is None else valid_mask.reshape(
        (-1,) + tuple(valid_mask.shape[2:]))
    errors = calculate_flow_error(tgt_flat, src_flat, event_mask=mask_flat)
    out = {"TEPE": errors["EPE"], "TAE": errors["AE"], "T3PE": errors["3PE"]}
    for i in range(m):
        e = calculate_flow_error(target[i], source[i],
                                 None if valid_mask is None else valid_mask[i])
        out[f"EPE_STEP{str(i).zfill(2)}"] = e["EPE"]
    return out


def predictions_from_lin_assumption(
        source: torch.Tensor,
        target_timestamps: Union[Sequence[float], torch.Tensor]) -> torch.Tensor:
    """Linear-in-time baseline: t * final flow, [N, 2, H, W] -> [M, N, 2, H, W]."""
    ts = torch.as_tensor(target_timestamps, dtype=source.dtype,
                         device=source.device)
    return ts[:, None, None, None, None] * source[None]


class MetricBank:
    """Accumulates (sum, count) per metric on the device.

    `update_device` takes a step's output dict (metric values plus optional
    '<key>__weight' entries) and adds to float64 sums without leaving the
    device; `compute` reads the whole bank back in one transfer.
    """

    def __init__(self):
        self.state: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def update_device(self, logs: Dict[str, torch.Tensor]) -> None:
        for key, val in logs.items():
            if key.endswith("__weight"):
                continue
            val = torch.as_tensor(val).to(torch.float64)
            wgt = logs.get(f"{key}__weight")
            # ones_like, not a tensor from a Python 1.0: a host-to-card copy
            # would synchronize the stream on every key.
            wgt = (torch.ones_like(val) if wgt is None
                   else torch.as_tensor(wgt).to(val))
            s, c = self.state.get(key, (0.0, 0.0))
            self.state[key] = (s + val * wgt, c + wgt)

    def compute(self) -> Dict[str, float]:
        if not self.state:
            return {}
        keys = sorted(self.state)
        host = torch.stack([torch.stack([self.state[k][0], self.state[k][1]])
                            for k in keys]).cpu().tolist()
        return {k: (s / c if c > 0 else float("nan"))
                for k, (s, c) in zip(keys, host)}

    def reset(self) -> None:
        self.state = {}

    def reduce_across_processes(self) -> "MetricBank":
        """The bank with each (sum, count) summed over the world's ranks:
        per-rank validation shards, then one all-reduce of the [K, 2]
        float64 sums (JAX: an all-gather, which gloo lacks for CUDA
        tensors).  Keys that some rank lacks count 0 there.  The same bank
        on every rank; no-op without a process group or in a world of
        one."""
        import torch.distributed as dist

        if not dist.is_initialized() or dist.get_world_size() == 1:
            return self
        names = [None] * dist.get_world_size()
        dist.all_gather_object(names, sorted(self.state))
        keys = sorted(set().union(*names))
        if self.state:
            dev = next(iter(self.state.values()))[1].device
        elif dist.get_backend() == "nccl":
            dev = torch.device("cuda", torch.cuda.current_device())
        else:
            dev = torch.device("cpu")
        zero = torch.zeros((), dtype=torch.float64, device=dev)
        local = torch.stack([
            torch.stack([torch.as_tensor(v, dtype=torch.float64).to(dev)
                         for v in self.state.get(k, (zero, zero))])
            for k in keys]) if keys else torch.zeros(
                (0, 2), dtype=torch.float64, device=dev)
        if keys:
            dist.all_reduce(local)
        out = MetricBank()
        out.state = {k: (local[i, 0], local[i, 1])
                     for i, k in enumerate(keys)}
        return out

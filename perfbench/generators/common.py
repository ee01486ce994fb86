"""What the generators share: seed streams, weights drawn from the seed on the
device, pinned host batches, and the training comparison.

Weights: every convolution or linear weight uniform in +-1/sqrt(fan_in)
(fan_in = weight[0].numel(), torch's default layer init, as the port's
`init_weights` draws it), its bias likewise, norm weights 1 and biases 0;
drawn in one call of a generator on the run's device, in the sorted order
of the parameter names, so the program and the reference get the same
tensors by name.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence, Tuple

import numpy as np


def streams(seed: int, n: int = 4) -> List[int]:
    """n independent 63-bit seeds from the run's seed (any size)."""
    ss = np.random.SeedSequence(int(seed))
    return [int(s.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for s in ss.spawn(n)]


def seeded_weights(named_shapes: Sequence[Tuple[str, tuple]], seed: int,
                   device) -> Dict[str, "torch.Tensor"]:
    import torch

    shapes = dict(named_shapes)
    names = sorted(shapes)
    bound: Dict[str, float] = {}
    for name in names:
        shape = shapes[name]
        if name.endswith(".weight") and len(shape) >= 2:
            bound[name] = 1.0 / math.sqrt(math.prod(shape[1:]))
        elif name.endswith(".bias"):
            w = shapes.get(name[:-len("bias")] + "weight")
            if w is not None and len(w) >= 2:
                bound[name] = 1.0 / math.sqrt(math.prod(w[1:]))
    sizes = [math.prod(shapes[n]) for n in names if n in bound]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    scale = torch.repeat_interleave(
        torch.tensor([bound[n] for n in names if n in bound], device=device),
        torch.tensor(sizes, device=device))
    flat = (flat * 2.0 - 1.0) * scale
    out, pos = {}, 0
    for name in names:
        shape = shapes[name]
        if name in bound:
            k = math.prod(shape)
            out[name] = flat[pos:pos + k].reshape(shape)
            pos += k
        elif name.endswith(".weight"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def load_weights(model, weights: dict) -> None:
    import torch

    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])


def pinned_batch(batch: dict, device: str) -> dict:
    """The batch's arrays copied into pinned host memory (as the CLI's
    loader stacks them) for a card; as they are for the CPU."""
    if device != "cuda":
        return batch
    from motionpriorcmax_tpu_torch.data.loader import pinned_empty

    out = {}
    for key, val in batch.items():
        if isinstance(val, np.ndarray):
            dst = pinned_empty(val.shape, val.dtype)
            dst[...] = val
            out[key] = dst
        else:
            out[key] = val
    return out


def host_to_device(batch: dict, keys: Sequence[str], device) -> dict:
    """The reference's own copy of the raw host arrays it needs."""
    import torch

    return {k: torch.from_numpy(np.asarray(batch[k])).to(device)
            for k in keys if k in batch}


def norms(tensors: Dict[str, "torch.Tensor"]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   keys) -> Tuple[float, str]:
    """max over `keys` of |prog - ref| / max(ref, the median leaf's ref):
    the gap between the two norms of a leaf, not the norm of their
    difference."""
    keys = list(keys)
    if not keys:
        return float("inf"), ""
    med = statistics.median(ref[k] for k in keys)
    best = (-1.0, "")
    for k in keys:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if gap > best[0]:
            best = (gap, k)
    return best


def training_numbers(prog_losses, ref_losses, prog_g1, ref_g1, prog_dp,
                     ref_dp) -> Dict[str, object]:
    """The numbers of a training cell, from the first steps' losses, the
    first gradient by leaf (tensors: the program's on the host) and the
    change over the steps by leaf norms.

    loss_gap: the worst of the steps' relative loss gaps.
    grad_gap, update_gap: the worst leaf's gap between the two norms of
      the first gradient, of the change (leaves whose reference gradient
      is under a thousandth of the median leaf's are left out of the
      change and of grad_diff_median: Adam moves them by round-off alone).
    grad_diff_median: the median leaf's |g_program - g_reference| over
      |g_reference| of the first gradient.  A precision step moves each
      element by a random error, which a leaf's norm feels only to second
      order; this difference feels it to first order (PERF.md, 6)."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(prog_losses, ref_losses))
    if any(not math.isfinite(p) for p in prog_losses):
        loss_gap = float("inf")
    ref_n = norms(ref_g1)
    grad_gap, grad_leaf = worst_leaf_gap(norms(prog_g1), ref_n, ref_n)
    med = statistics.median(ref_n.values())
    moved = [k for k in ref_n if ref_n[k] >= 1e-3 * med]
    update_gap, update_leaf = worst_leaf_gap(prog_dp, ref_dp, moved)
    diffs = [float((prog_g1[k].to(ref_g1[k].device).double()
                    - ref_g1[k].double()).norm()) / ref_n[k] for k in moved]
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "grad_leaf": grad_leaf, "update_gap": update_gap,
            "update_leaf": update_leaf,
            "grad_diff_median": statistics.median(diffs) if diffs
            else float("inf"),
            "left_out": sorted(set(ref_n) - set(moved))}


def raft_bins(config: dict):
    """(context bins, bins of the voxel grid) of a RAFT-Spline config."""
    nb = config["tree"]["model"]["num_bins"]
    return int(nb["context"]), int(nb["context"]) + int(nb["correlation"]) - 1


def raft_reference(config: dict, precision: str, phase: str):
    """The reference RAFT-Spline of a config, with the iterations of
    `phase` ('train' or 'test') and the config's `precision` ('stated'
    or 'control')."""
    from ..reference.nets import RAFTSpline

    m = config["tree"]["model"]
    ev = m["correlation"]["ev"]
    return RAFTSpline(
        nbins_context=raft_bins(config)[0],
        nbins_correlation=int(m["num_bins"]["correlation"]),
        degree=int(m["bezier_degree"]),
        target_indices=tuple(ev["target_indices"]),
        levels=tuple(ev["levels"]), radius=int(ev["radius"][0]),
        hidden=int(m["hidden"]["dim"]), context=int(m["context"]["dim"]),
        feature=int(m["feature"]["dim"]), motion=int(m["motion"]["dim"]),
        iters=int(m["num_iter"][phase]),
        precision=config[precision + "_precision"])


"""Supervised RAFT-Spline training (`traj-train --loss supervised`'s step):
every iteration's upsampled Bezier curves against GT flow at the GT
timestamps, L1 weighted gamma^(iters-1-i), AdamW with the one-cycle
schedule.  With the configuration's `model.use_boundary_images`, each
sample also carries its two boundary frames and the model takes them.

Traffic keys: "pool", "gt_steps" (GT timestamps over the window, evenly
spaced, the last at 1), "density" (share of nonzero voxel-grid entries),
"gamma", "schedule_steps" (the one-cycle's length, traj-train's
--max-steps).

A sample, as MultiFlow's reader gives it, drawn from the seed: a
normalized voxel grid (`inputs.traj_samples`), GT flow without a validity
mask (MultiFlow has none), and with images the pair of frames [3, H, W]
f32 of integer values 0..255 (the reader's high byte of its 16-bit PNGs).
The batches are stacked by the loader's own `stack_samples`.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from . import common, inputs, traj_train


class CellRun(traj_train.CellRun):
    host_keys = ("ev_repr", "img", "flow", "flow_timestamps")

    @property
    def images(self) -> bool:
        return bool(self.config["tree"]["model"].get("use_boundary_images"))

    @property
    def samples_per_step(self) -> int:
        return int(self.pool[0]["ev_repr"].shape[0])

    def make_pool(self, rng, n: int) -> List[dict]:
        from motionpriorcmax_tpu_torch.data.collate import stack_samples

        h, w, bsz = self._dims()
        ctx, total = common.raft_bins(self.config)
        pool = []
        for _ in range(n):
            samples = inputs.traj_samples(
                rng, bsz, h, w, total, ctx,
                gt_steps=int(self.traffic["gt_steps"]),
                density=float(self.traffic["density"]))
            for s in samples:
                del s["flow_valid"]
                if self.images:
                    s["img"] = rng.integers(0, 256, (2, 3, h, w)).astype(
                        np.float32)
            batch = stack_samples(samples)
            # The loop's own default: a batch without events has no
            # polarity split.
            batch["num_pos_events"] = -1
            pool.append(batch)
        return pool

    # -- the program ----------------------------------------------------------

    def program_step(self, host_batch: dict):
        from motionpriorcmax_tpu_torch.training.loop import to_device
        from motionpriorcmax_tpu_torch.training.raft_spline import (
            raft_supervised_train_step)

        batch = to_device(host_batch, self.device)
        logs = raft_supervised_train_step(
            self.program, batch, gamma=float(self.traffic["gamma"]))
        return logs["train_losses/total"]

    # -- the reference --------------------------------------------------------

    def reference_model(self, precision: str):
        if not self.images:
            return common.raft_reference(self.config, precision, "train")
        from ..reference.raft_ei import RAFTSplineEI

        m = self.config["tree"]["model"]
        ev = m["correlation"]["ev"]
        return RAFTSplineEI(
            nbins_context=common.raft_bins(self.config)[0],
            nbins_correlation=int(m["num_bins"]["correlation"]),
            degree=int(m["bezier_degree"]),
            target_indices=tuple(ev["target_indices"]),
            levels=tuple(ev["levels"]),
            img_levels=int(m["correlation"]["img"]["levels"]),
            radius=int(ev["radius"][0]), hidden=int(m["hidden"]["dim"]),
            context=int(m["context"]["dim"]),
            feature=int(m["feature"]["dim"]), motion=int(m["motion"]["dim"]),
            iters=int(m["num_iter"]["train"]),
            precision=self.config[precision + "_precision"])

    def reference_step(self, model, params, batch, gen, npos):
        from ..reference import raft_ei

        return raft_ei.supervised_step(model, params, batch,
                                       float(self.traffic["gamma"]))

    # -- counts ---------------------------------------------------------------

    def model_flops(self) -> int:
        """The model's forward and parameter backward with the upsampling
        of every iteration, which the loss takes (the curves and the L1 are
        loss work, as the focus loss is in the other training cells)."""
        import torch
        from ..reference.nets import cvx_upsample
        from ..roofline import flops

        h, w, bsz = self._dims()
        _, total = common.raft_bins(self.config)
        images = self.images

        def forward(model, x):
            if images:
                frames = torch.empty(bsz, 3, h, w, device=x.device)
                p, m = model(x, (frames, frames), keep_all=True)
            else:
                p, m = model(x, keep_all=True)
            return [cvx_upsample(a, b) for a, b in zip(p, m)]

        return flops.count(self.reference_model("stated"),
                           torch.empty(bsz, total, h, w), backward=True,
                           forward=forward)

    def launch_bounds(self) -> Dict[str, float]:
        """No call of the step has a bound that follows from shapes (the
        lookup and its backward depend on the windows in range)."""
        return {}

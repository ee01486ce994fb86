"""Self-supervised RAFT-Spline training (`traj-train`'s step): the last
iteration's upsampled Bezier curves, one trajectory per superpixel, the
focus loss, AdamW with the one-cycle schedule.

Traffic keys: "pool", "events" per sample, "capacity" per sample,
"cell_sort", "loss" (values over the configuration's loss section),
"schedule_steps" (the one-cycle's length, traj-train's --max-steps).
"""

from __future__ import annotations

import copy
from typing import Dict, List

from . import common, inputs
from .training import TrainRun


class CellRun(TrainRun):
    host_keys = ("events", "ev_repr")

    def _tree(self) -> dict:
        tree = copy.deepcopy(self.config["tree"])
        tree["loss"].update(self.traffic.get("loss", {}))
        return tree

    def _dims(self):
        t = self.config["tree"]
        return (int(self.config["height"]), int(self.config["width"]),
                int(t["training"]["batch_size"]))

    def make_pool(self, rng, n: int) -> List[dict]:
        from motionpriorcmax_tpu_torch.data.collate import (
            collate_fixed_capacity)

        h, w, bsz = self._dims()
        ctx, total = common.raft_bins(self.config)
        loss = self.config["tree"]["loss"]
        sort = (((h, w), int(loss["num_bins"]),
                 int(loss["lut_superpixel_size"]))
                if self.traffic["cell_sort"] else None)
        pool = []
        for _ in range(n):
            samples = inputs.traj_samples(rng, bsz, h, w, total, ctx,
                                          events=int(self.traffic["events"]))
            batch = collate_fixed_capacity(
                samples, int(self.traffic["capacity"]), polarity_aware=True,
                lut_cell_sort_params=sort)
            pool.append({k: batch[k] for k in ("ev_repr", "events",
                                                "lut_cell_ends",
                                                "num_pos_events")
                         if k in batch})
        return pool

    # -- the program ----------------------------------------------------------

    def make_program(self):
        import torch
        from motionpriorcmax_tpu_torch.cli.main import traj_train_configs
        from motionpriorcmax_tpu_torch.models.raft_spline import RAFTSpline
        from motionpriorcmax_tpu_torch.training.raft_spline import (
            RAFTTrainState, make_optimizer)

        h, w, _ = self._dims()
        cfg, tc, self.loss_cfg = traj_train_configs(
            self._tree(), (h, w), int(self.traffic["schedule_steps"]))
        with torch.device(self.device):
            model = RAFTSpline(cfg)
        opt, sched = make_optimizer(model, tc)
        return RAFTTrainState(model=model, optimizer=opt, scheduler=sched,
                              tc=tc)

    def program_model(self):
        return self.program.model

    def program_optimizer(self):
        return self.program.optimizer

    def program_step(self, host_batch: dict):
        from motionpriorcmax_tpu_torch.training.loop import to_device
        from motionpriorcmax_tpu_torch.training.raft_spline import (
            raft_train_step)

        batch = to_device(host_batch, self.device)
        logs = raft_train_step(self.program, batch, self.gen, self.loss_cfg,
                               int(host_batch["num_pos_events"]))
        return logs["train_losses/total"]

    # -- the reference --------------------------------------------------------

    def reference_model(self, precision: str):
        return common.raft_reference(self.config, precision, "train")

    def reference_optimizer(self) -> dict:
        t = self.config["tree"]["training"]
        return {"lr": float(t["learning_rate"]),
                "weight_decay": float(t["weight_decay"])}

    def reference_lr(self, step: int) -> float:
        from ..reference.optim import onecycle_lr

        return onecycle_lr(self.reference_optimizer()["lr"],
                           int(self.traffic["schedule_steps"]),
                           float(self.config["pct_start"]), step)

    def reference_step(self, model, params, batch, gen, npos):
        from ..reference import focus, steps

        tree = self._tree()
        h, w, _ = self._dims()
        lc = tree["loss"]
        loss_cfg = focus.loss_config(
            lc, (h, w), int(lc["num_bins"]),
            interp_band_dynamic=lc.get("interp_band_dynamic", "per_group"))
        times = focus.reconstruction_times(int(lc["num_bins"]), gen)
        return steps.raft_step(model, params, loss_cfg, batch, times, npos)

    # -- counts ---------------------------------------------------------------

    def model_flops(self) -> int:
        import torch
        from ..roofline import flops
        from ..reference.nets import cvx_upsample

        h, w, bsz = self._dims()
        _, total = common.raft_bins(self.config)

        def forward(model, x):
            p, m = model(x)
            return cvx_upsample(p[-1], m[-1])

        return flops.count(self.reference_model("stated"),
                           torch.empty(bsz, total, h, w), backward=True,
                           forward=forward)

    def launch_bounds(self) -> Dict[str, float]:
        """Least seconds per step of the port calls whose bound follows
        from shapes (the lookup and its backward stay out)."""
        from ..roofline import bounds

        h, w, bsz = self._dims()
        loss = self.config["tree"]["loss"]
        s, nb = int(loss["lut_superpixel_size"]), int(loss["num_bins"])
        ev = self.pool[0]["events"]
        return bounds.focus_loss_step(
            bsz, ev.shape[1], int(self.pool[0]["num_pos_events"]),
            inputs.live_counts(self.pool), h, w,
            -(-h // s) * -(-w // s) * nb, self.traffic["cell_sort"])

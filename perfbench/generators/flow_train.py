"""DSEC flow training (`flow-train`'s step): the UNet on voxel grids,
trajectories per 4 x 4 tile, the focus loss, AdamW.

Traffic keys: "pool" (distinct batches cycled), "events" per window,
"capacity" per sample (both polarity halves), "cell_sort" (the LUT-cell
sort and 'lut_cell_ends', as `flow-train`'s loader collates), "loss"
(values over the configuration's loss section, e.g. knn_method),
"device_voxelize" (no host voxel grid: the step votes it on the device).
"""

from __future__ import annotations

import copy
from typing import Dict, List

from . import inputs
from .training import TrainRun

UNET_WIDTHS = (64, 128, 256, 512, 1024)


class CellRun(TrainRun):
    host_keys = ("events",)

    # -- shapes ---------------------------------------------------------------

    def _tree(self) -> dict:
        tree = copy.deepcopy(self.config["tree"])
        tree["loss"].update(self.traffic.get("loss", {}))
        return tree

    def _dims(self):
        c = self.config["tree"]["common"]
        return (int(c["height"]), int(c["width"]), int(c["num_bins"]),
                int(self.config["tree"]["data"]["batch_size"]))

    def make_pool(self, rng, n: int) -> List[dict]:
        from motionpriorcmax_tpu_torch.data.collate import (
            collate_fixed_capacity)

        h, w, nb, bsz = self._dims()
        s = int(self.config["tree"]["loss"]["lut_superpixel_size"])
        sort = ((h, w), nb, s) if self.traffic["cell_sort"] else None
        pool = []
        for _ in range(n):
            samples = inputs.flow_samples(
                rng, bsz, int(self.traffic["events"]), h, w, nb,
                voxel=not self.traffic["device_voxelize"])
            pool.append(collate_fixed_capacity(
                samples, int(self.traffic["capacity"]), polarity_aware=True,
                lut_cell_sort_params=sort))
        return pool

    # -- the program ----------------------------------------------------------

    def make_program(self):
        import torch
        from motionpriorcmax_tpu_torch.cli.main import flow_configs
        from motionpriorcmax_tpu_torch.config import propagate_config
        from motionpriorcmax_tpu_torch.training.trajectory_net import (
            TrainState, TrajectoryModel, make_optimizer)

        self.cfg, self.loss_cfg = flow_configs(propagate_config(self._tree()))
        with torch.device(self.device):
            model = TrajectoryModel(self.cfg)
        return TrainState(model=model, optimizer=make_optimizer(model,
                                                                self.cfg.lr))

    def program_model(self):
        return self.program.model.unet

    def program_optimizer(self):
        return self.program.optimizer

    def program_step(self, host_batch: dict):
        from motionpriorcmax_tpu_torch.training.loop import to_device
        from motionpriorcmax_tpu_torch.training.trajectory_net import (
            train_step)

        logs = train_step(self.program, to_device(host_batch, self.device),
                          self.gen, self.cfg, self.loss_cfg,
                          int(host_batch["num_pos_events"]))
        return logs["train_losses/total"]

    # -- the reference --------------------------------------------------------

    def reference_model(self, precision: str):
        from ..reference.nets import UNet

        m = self.config["tree"]["model"]
        return UNet(self._dims()[2], 2 * int(m["num_basis"]),
                    tuple(m.get("unet_widths", UNET_WIDTHS)),
                    self.config[precision + "_precision"])

    def reference_optimizer(self) -> dict:
        return {"lr": float(self.config["tree"]["model"]["lr"]),
                "weight_decay": float(self.config["weight_decay"])}

    def reference_step(self, model, params, batch, gen, npos):
        from ..reference import focus, steps

        tree = self._tree()
        h, w, nb, _ = self._dims()
        m = tree["model"]
        linear = m["basis_type"] == "polynomial" and int(m["num_basis"]) == 1
        loss_cfg = focus.loss_config(tree["loss"], (h, w), nb,
                                     interp_band_per_bin=linear)
        model_cfg = {"num_bins": nb, "num_basis": int(m["num_basis"]),
                     "patch_size": int(self.config["tree"]["common"]
                                       ["patch_size"]),
                     "anchor_time": 0.0}
        times = focus.reconstruction_times(nb, gen)
        return steps.flow_step(model, params, loss_cfg, model_cfg, batch,
                               times, npos)

    # -- counts ---------------------------------------------------------------

    def model_flops(self) -> int:
        import torch
        from ..roofline import flops

        h, w, nb, bsz = self._dims()
        return flops.count(self.reference_model("stated"),
                           torch.empty(bsz, nb, h, w), backward=True)

    def launch_bounds(self) -> Dict[str, float]:
        """Least seconds per step of each port call the step makes."""
        from ..roofline import bounds

        h, w, nb, bsz = self._dims()
        s = int(self.config["tree"]["loss"]["lut_superpixel_size"])
        ev = self.pool[0]["events"]
        out = bounds.focus_loss_step(
            bsz, ev.shape[1], int(self.pool[0]["num_pos_events"]),
            inputs.live_counts(self.pool), h, w,
            -(-h // s) * -(-w // s) * nb, self.traffic["cell_sort"])
        if self.traffic["device_voxelize"]:
            out["voxel_vote"] = bounds.least_seconds(
                bounds.voxel_vote(bsz, ev.shape[1], nb, h, w))
        return out

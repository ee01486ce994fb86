"""RAFT-Spline trajectory evaluation (`traj-val`'s request): the CLI's
`stack_traj_batch` of B samples, `raft_validation_step`, and the
request's metrics pulled to the host; one caller, each request issued
after the previous one's metrics arrived.

Traffic keys: "pool" (distinct batches cycled), "gt_steps" (GT flow
timestamps per sample), "density" (share of nonzero voxels),
"check_requests" (requests compared with the reference: the window's
first and others drawn from the seed among its first "check_among").
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from . import common, inputs


class CellRun:
    kind = "eval"

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: str = "cuda", program: bool = True):
        import torch

        self.config, self.traffic, self.device = config, traffic, device
        s_data, s_weights, _, s_pick = common.streams(seed)
        rng = np.random.default_rng(s_data)
        h, w, self.bsz = self._dims()
        ctx, total = common.raft_bins(self.config)
        self.pool = [inputs.traj_samples(rng, self.bsz, h, w, total, ctx,
                                         gt_steps=int(traffic["gt_steps"]),
                                         density=float(traffic["density"]))
                     for _ in range(int(traffic["pool"]))]
        self.timestamps = tuple(float(t) for t in
                                self.pool[0][0]["flow_timestamps"])
        with torch.device("meta"):
            shapes = [(k, tuple(p.shape)) for k, p in
                      self.reference_model("stated").named_parameters()]
        self.weights = common.seeded_weights(shapes, s_weights, device)
        # The window's first request, and the rest drawn from the seed
        # among the first check_among (a window of any length finishes
        # the first).
        among = int(traffic["check_among"])
        rest = min(int(traffic["check_requests"]), among) - 1
        self.picked = {0} | set(int(i) + 1 for i in np.random.default_rng(
            s_pick).choice(among - 1, size=rest, replace=False))
        self.captured: Dict[int, dict] = {}
        self.cursor = 0
        if not program:
            return
        self.program = self.make_program()
        # Warm-up: one request on every distinct batch (same shapes).
        for _ in range(len(self.pool)):
            self.step()
        self.cursor = 0
        self.captured.clear()

    def _dims(self):
        return (int(self.config["height"]), int(self.config["width"]),
                int(self.config["tree"]["batch_size"]))

    @property
    def samples_per_step(self) -> int:
        return self.bsz

    # -- the program ----------------------------------------------------------

    def make_program(self):
        import torch
        from motionpriorcmax_tpu_torch.cli.main import raft_config_from_tree
        from motionpriorcmax_tpu_torch.models.raft_spline import RAFTSpline

        with torch.device(self.device):
            model = RAFTSpline(raft_config_from_tree(
                self.config["tree"]["model"], "test"))
        common.load_weights(model, self.weights)
        model.eval()
        self._out = None

        def keep(_mod, _inp, out):
            self._out = out[1]

        model.register_forward_hook(keep)
        return model

    def step(self) -> float:
        """One request; returns its latency in ms (host clock, from the
        host samples handed over to the metrics on the host)."""
        import torch
        from motionpriorcmax_tpu_torch.cli.main import stack_traj_batch
        from motionpriorcmax_tpu_torch.training.raft_spline import (
            raft_validation_step)

        i = self.cursor
        t0 = time.perf_counter()
        batch = stack_traj_batch(self.pool[i % len(self.pool)],
                                 torch.device(self.device), False)
        logs = raft_validation_step(self.program, batch, self.timestamps)
        values = torch.cat([v.detach().float().reshape(-1)
                            for v in logs.values()]).cpu()
        ms = (time.perf_counter() - t0) * 1e3
        if i in self.picked:
            names = list(logs)
            self.captured[i] = {"params_up": self._out,
                                "epe": float(values[names.index("val/epe")])}
        self._out = None
        self.cursor += 1
        return ms

    def free_program(self) -> None:
        import gc

        import torch

        self.program = None
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()

    # -- the reference --------------------------------------------------------

    def reference_model(self, precision: str):
        return common.raft_reference(self.config, precision, "test")

    def reference_answers(self, precision: str, indices) -> Dict[int, tuple]:
        """(params_up, epe) of the reference for each pool batch that the
        requests `indices` used."""
        import torch
        from ..reference.steps import raft_request

        model = self.reference_model(precision).to(self.device).eval()
        common.load_weights(model, self.weights)
        out = {}
        for j in sorted({i % len(self.pool) for i in indices}):
            samples = self.pool[j]
            batch = {k: torch.from_numpy(np.stack([s[k] for s in samples])
                                         ).to(self.device)
                     for k in ("ev_repr", "flow")}
            out[j] = raft_request(model, batch, self.timestamps)
        return out

    def check(self) -> Dict[str, object]:
        """Each captured request's curve parameters and EPE against the
        reference's on the same samples."""
        captured = dict(self.captured)
        self.captured.clear()
        self.free_program()
        if not captured:
            return {"params_gap": float("inf"), "epe_gap": float("inf"),
                    "compared": 0}
        ref = self.reference_answers("stated", captured)
        params_gap, epe_gap = 0.0, 0.0
        for i, got in captured.items():
            r_up, r_epe = ref[i % len(self.pool)]
            up = got["params_up"]
            if up is None or up.shape != r_up.shape:
                params_gap = float("inf")
                continue
            diff = (got["params_up"].double() - r_up.double()).norm()
            params_gap = max(params_gap, float(diff / r_up.double().norm()))
            epe_gap = max(epe_gap, abs(got["epe"] - float(r_epe))
                          / max(abs(float(r_epe)), 1e-30))
        return {"params_gap": params_gap, "epe_gap": epe_gap,
                "compared": len(captured)}

    # -- counts ---------------------------------------------------------------

    def model_flops(self) -> int:
        import torch
        from ..roofline import flops

        h, w, bsz = self._dims()
        _, total = common.raft_bins(self.config)
        return flops.count(self.reference_model("stated"),
                           torch.empty(bsz, total, h, w), backward=False,
                           forward=lambda m, x: m.upsampled(x))

    def launch_bounds(self) -> Dict[str, float]:
        """The lookup's bound needs its in-range windows, which a traced
        run does not see: no call of this cell is bounded."""
        return {}


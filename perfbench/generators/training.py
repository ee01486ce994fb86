"""A training cell's run: one training state built in set-up, driven from
the seed through its first steps by the window's own call, then handed to
the window; after the window, the reference follows the same first steps
and the two are compared.

Set-up: the pool of distinct host batches (pinned, as the CLI's loader
hands them over), weights from the seed on the device, the program's
state, then CHECK_STEPS steps on the pool's first batches (they are the
warm-up too: every batch of the pool has the same shapes).  Kept from
them: each step's loss, the first gradient as the optimizer got it
(AdamW's first moment after one step over 1 - beta1, copied to the host)
and the change of the parameters after the last, by leaf norms.

A subclass gives the pool, the program's state and step, and the
reference's model and step.
"""

from __future__ import annotations

import gc
from typing import Dict, List, Tuple

import numpy as np

from . import common

CHECK_STEPS = 3


class TrainRun:
    kind = "train"
    host_keys: Tuple[str, ...] = ()

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: str = "cuda", program: bool = True):
        import torch

        self.config, self.traffic, self.device = config, traffic, device
        self.s_data, self.s_weights, self.s_times, _ = common.streams(seed)
        self.pool = [common.pinned_batch(b, device)
                     for b in self.make_pool(np.random.default_rng(
                         self.s_data), int(traffic["pool"]))]
        if len(self.pool) < CHECK_STEPS:
            raise ValueError(f"the pool needs {CHECK_STEPS} distinct batches")
        with torch.device("meta"):
            shapes = [(k, tuple(p.shape)) for k, p in
                      self.reference_model("stated").named_parameters()]
        self.weights = common.seeded_weights(shapes, self.s_weights, device)
        if not program:
            return
        self.program = self.make_program()
        model = self.program_model()
        common.load_weights(model, self.weights)
        self.gen = torch.Generator().manual_seed(self.s_times)
        self.losses: List[float] = []
        for i in range(CHECK_STEPS):
            self.losses.append(float(self.program_step(self.pool[i])))
            if i == 0:
                opt = self.program_optimizer()
                b1 = opt.param_groups[0]["betas"][0]
                self.g1 = {k: (opt.state[p]["exp_avg"] / (1.0 - b1)).cpu()
                           for k, p in model.named_parameters()}
        self.dp = common.norms({k: p.detach() - self.weights[k]
                                for k, p in model.named_parameters()})
        self.cursor = CHECK_STEPS

    # -- the window -------------------------------------------------------

    @property
    def samples_per_step(self) -> int:
        return int(self.pool[0]["events"].shape[0])

    def step(self) -> None:
        self.program_step(self.pool[self.cursor % len(self.pool)])
        self.cursor += 1

    def free_program(self) -> None:
        import torch

        self.program = None
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ----------------------------------------------------

    def reference_run(self, precision: str):
        """(losses, first gradient by leaf, change's leaf norms) of the
        reference over the first steps, from the seed's weights."""
        import torch
        from ..reference.optim import AdamW

        model = self.reference_model(precision).to(self.device).train()
        common.load_weights(model, self.weights)
        params = dict(model.named_parameters())
        opt = AdamW(params, **self.reference_optimizer())
        gen = torch.Generator().manual_seed(self.s_times)
        losses, g1 = [], None
        for i in range(CHECK_STEPS):
            batch = common.host_to_device(self.pool[i], self.host_keys,
                                          self.device)
            npos = int(self.pool[i]["num_pos_events"])
            loss, grads = self.reference_step(model, params, batch, gen, npos)
            losses.append(float(loss.detach()))
            if g1 is None:
                g1 = {k: g.detach().clone() for k, g in grads.items()}
            opt.step(grads, self.reference_lr(i))
            del loss, grads, batch
        dp = common.norms({k: p.detach() - self.weights[k]
                           for k, p in params.items()})
        return losses, g1, dp

    def check(self) -> Dict[str, object]:
        """The program's first steps against the reference's."""
        self.free_program()
        ref_losses, ref_g1, ref_dp = self.reference_run("stated")
        out = common.training_numbers(self.losses, ref_losses, self.g1,
                                      ref_g1, self.dp, ref_dp)
        out["losses"] = self.losses
        out["reference_losses"] = ref_losses
        return out

    def reference_lr(self, step: int) -> float:
        return self.reference_optimizer()["lr"]

    # -- a subclass gives ---------------------------------------------------

    def make_pool(self, rng, n: int) -> List[dict]:
        raise NotImplementedError

    def make_program(self):
        raise NotImplementedError

    def program_model(self):
        raise NotImplementedError

    def program_optimizer(self):
        raise NotImplementedError

    def program_step(self, host_batch: dict):
        raise NotImplementedError

    def reference_model(self, precision: str):
        raise NotImplementedError

    def reference_optimizer(self) -> dict:
        raise NotImplementedError

    def reference_step(self, model, params, batch, gen, npos):
        raise NotImplementedError

    def model_flops(self) -> int:
        raise NotImplementedError

    def launch_bounds(self) -> Dict[str, float]:
        raise NotImplementedError

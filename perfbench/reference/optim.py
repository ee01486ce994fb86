"""AdamW (Loshchilov and Hutter, decoupled weight decay) and the linear
one-cycle schedule (optax.linear_onecycle_schedule, pct_final 1.0), plain."""

from __future__ import annotations

import math
from typing import Dict

import torch


class AdamW:
    """p <- p (1 - lr wd); m, v moved by (b1, b2); p <- p - lr m_hat /
    (sqrt(v_hat) + eps).  `params` is a name -> tensor dict, updated in
    place; `state[name]` holds (m, v)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.wd = params, lr, weight_decay
        self.b1, self.b2 = betas
        self.eps, self.t = eps, 0
        self.state = {k: (torch.zeros_like(p), torch.zeros_like(p))
                      for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float = None) -> None:
        lr = self.lr if lr is None else lr
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            m, v = self.state[k]
            p.mul_(1.0 - lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.addcdiv_(m, v.sqrt() / math.sqrt(c2) + self.eps, value=-lr / c1)


def onecycle_lr(lr: float, total_steps: int, pct_start: float,
                count: int) -> float:
    """The rate at update `count` (0-based) of a one-cycle over
    total_steps + 100 updates: lr / 25 rising linearly to lr over the first
    pct_start of them, then falling linearly to lr 1e-4 at the end."""
    steps = total_steps + 100
    bounds = (0, int(pct_start * steps), steps)
    values = (lr / 25.0, lr, lr * 1e-4)
    if count >= bounds[2]:
        return values[2]
    i = 1 if count >= bounds[1] else 0
    pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
    return pct * (values[i + 1] - values[i]) + values[i]

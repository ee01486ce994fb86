"""Learned curve-basis MLP: t -> K basis values (JAX: models/basis_mlp.py)."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


class BasisMLP(nn.Module):
    """Linear 1 -> hidden (x depth) -> num_basis with an activation between.

    The trajectory path uses depth 2 with ReLU; the flow path depth 3 with
    LeakyReLU(0.01).
    """

    def __init__(self, num_basis: int, hidden: int = 64, depth: int = 3,
                 activation: str = "leaky_relu"):
        super().__init__()
        if activation not in ("leaky_relu", "relu"):
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        dims = [1] + [hidden] * depth + [num_basis]
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        """t: [..., 1] -> [..., num_basis]."""
        x = t
        for layer in self.layers[:-1]:
            x = layer(x)
            x = F.relu(x) if self.activation == "relu" else F.leaky_relu(x, 0.01)
        return self.layers[-1](x)

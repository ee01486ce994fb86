"""Motion bases and trajectory evaluation (JAX: ops/basis.py).

  eval_basis(times, num_basis, kind)          -> [T, K] basis matrix
  compute_trajectories(coeffs, basis_matrix)  -> [B, T, N, 2] positions
  bernstein_basis(times, degree)              -> [T, degree] (Bezier curves)
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch


def eval_basis(times: torch.Tensor, num_basis: int, kind: str,
               mlp_apply: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
               ) -> torch.Tensor:
    """[T] times -> [T, K] basis values.

    dct: sqrt(2) cos(pi/2 (2t + 1) k); polynomial: t^k, k = 1..K;
    learned: mlp_apply([T, 1]) -> [T, K].
    """
    if kind == "dct":
        k = torch.arange(1, num_basis + 1, dtype=times.dtype,
                         device=times.device)
        return math.sqrt(2.0) * torch.cos(
            (math.pi / 2.0) * (2.0 * times[:, None] + 1.0) * k[None, :])
    if kind == "polynomial":
        k = torch.arange(1, num_basis + 1, dtype=times.dtype,
                         device=times.device)
        return times[:, None] ** k[None, :]
    if kind == "learned":
        if mlp_apply is None:
            raise ValueError("the learned basis needs mlp_apply")
        out = mlp_apply(times[:, None])
        if tuple(out.shape) != (times.shape[0], num_basis):
            raise ValueError(f"learned basis gave {tuple(out.shape)}")
        return out
    raise ValueError(f"unknown basis kind {kind!r}")


def compute_trajectories(coeffs: torch.Tensor, basis_matrix: torch.Tensor
                         ) -> torch.Tensor:
    """[B, S, 2, N, K] coefficients (y, x) x [T, K] basis -> [B, T, N, 2]
    positions, summed over the K basis terms and the S scales."""
    if coeffs.dim() != 5 or basis_matrix.dim() != 2:
        raise ValueError(f"coeffs [B, S, 2, N, K] and basis [T, K] expected, "
                         f"got {tuple(coeffs.shape)}, {tuple(basis_matrix.shape)}")
    return torch.einsum("bsdnk,tk->btnd", coeffs, basis_matrix)


def bernstein_basis(times: torch.Tensor, degree: int) -> torch.Tensor:
    """Bernstein basis with P0 == 0: [T] times -> [T, degree].

    b_i(t) = C(degree, i) * (1-t)^(degree-i) * t^i for i = 1..degree; column
    d belongs to control point P_{d+1}.
    """
    i = torch.arange(1, degree + 1, dtype=times.dtype, device=times.device)
    binom = torch.tensor([_comb(degree, k) for k in range(1, degree + 1)],
                         dtype=torch.float64).to(times.dtype).to(times.device)
    t = times[:, None]
    return binom[None, :] * (1.0 - t) ** (degree - i)[None, :] * t ** i[None, :]


def _comb(n: int, k: int) -> float:
    out = 1.0
    for j in range(k):
        out = out * (n - j) / (j + 1)
    return out

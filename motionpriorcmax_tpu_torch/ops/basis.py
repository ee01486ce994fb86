"""Bernstein basis for the Bezier curves (JAX: ops/basis.py:80-107)."""

from __future__ import annotations

import torch


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

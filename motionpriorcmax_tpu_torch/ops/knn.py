"""Exact blocked K-nearest neighbours (JAX: ops/knn.py::knn_blocked,
method 'exact').

Plain PyTorch: the JAX package has no kernel here (it uses lax.top_k).
Distances are ranked with the same expanded form |q|^2 - 2 q.db + |db|^2 as
JAX (`torch.cdist` ranks near-ties differently), the cross term in full
f32 (TF32 would round pixel coordinates of ~640 to errors of hundreds of
px^2), and the K selected squared-l2 distances are then refined by direct
subtraction.  Ties at the K-th neighbour may still be broken differently
from `lax.top_k`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..device import no_tf32

# Distance entries per block: queries are processed in blocks of
# max(1, KNN_BLOCK_ELEMS // (G * N)) rows, bounding the [G, block, N]
# distance tensor (and the top-k's scratch) to ~1 GiB of f32.
KNN_BLOCK_ELEMS = 1 << 28


def _pairwise_dist(q: torch.Tensor, db: torch.Tensor, norm: str
                   ) -> torch.Tensor:
    """[Cq, D] x [G, N, D] -> [G, Cq, N] squared-l2 or l1 distances."""
    if norm == "l2":
        qq = torch.sum(q * q, dim=-1)[None, :, None]            # [1, Cq, 1]
        dd = torch.sum(db * db, dim=-1)[:, None, :]             # [G, 1, N]
        cross = torch.matmul(q[None], db.transpose(1, 2))       # [G, Cq, N]
        return qq - 2.0 * cross + dd
    if norm == "l1":
        return (q[None, :, None, :] - db[:, None, :, :]).abs().sum(-1)
    raise ValueError(f"unknown dist norm {norm!r}")


def knn_blocked(queries: torch.Tensor, database: torch.Tensor, k: int, *,
                norm: str = "l2") -> Tuple[torch.Tensor, torch.Tensor]:
    """K nearest database points of each query, for G databases at once.

    Args:
      queries: [Q, D] query coordinates (shared by all databases).
      database: [G, N, D] database coordinates.
      k: neighbours; min(k, N) are returned.
      norm: 'l2' (squared euclidean, the reference's) or 'l1'.

    Returns:
      (indices [G, Q, K] int64, distances [G, Q, K] f32), nearest first.
    """
    g, n, d = database.shape
    q = queries.shape[0]
    k = min(k, n)
    block = max(1, min(q, KNN_BLOCK_ELEMS // max(g * n, 1)))
    idx_out, dist_out = [], []
    with no_tf32():
        for q0 in range(0, q, block):
            qb = queries[q0:q0 + block]
            dist = _pairwise_dist(qb, database, norm)
            nd, idx = torch.topk(dist, k, dim=-1, largest=False, sorted=True)
            if norm == "l2":
                sel = torch.gather(
                    database[:, None].expand(-1, qb.shape[0], -1, -1), 2,
                    idx[..., None].expand(-1, -1, -1, d))      # [G, Cq, K, D]
                diffs = qb[None, :, None, :] - sel
                nd = torch.sum(diffs * diffs, dim=-1)
            idx_out.append(idx)
            dist_out.append(nd)
    return torch.cat(idx_out, dim=1), torch.cat(dist_out, dim=1)

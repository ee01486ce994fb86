"""Blocked K-nearest neighbours (JAX: ops/knn.py): `knn_blocked` over all
database points, `knn_grid_window` over a spatial-hash window, and
`knn_batched` with per-batch queries.

Plain PyTorch: the JAX package has no kernel here (it uses lax.top_k and
lax.approx_min_k).  Method 'approx' computes the exact K nearest: JAX's
lax.approx_min_k is exact off the TPU (it falls back to a sort there), so
only the order of equal distances can differ, as with 'exact'.

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
# Candidate entries per block of knn_grid_window: [G, block, (2R+1)^2 C]
# candidates with their int64 indices and (y, x) positions, ~2 GiB.
GRID_BLOCK_ELEMS = 1 << 26
METHODS = ("exact", "approx")


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


def _check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown knn method {method!r} (exact, approx)")


def knn_blocked(queries: torch.Tensor, database: torch.Tensor, k: int, *,
                norm: str = "l2", method: str = "exact"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K nearest database points of each query, for G databases at once.

    Args:
      queries: [Q, D] query coordinates (shared by all databases).
      database: [G, N, D] database coordinates.
      k: neighbours; min(k, N) are returned.
      norm: 'l2' (squared euclidean, the reference's) or 'l1'.
      method: 'exact' or 'approx' (the same exact top-k, see above).

    Returns:
      (indices [G, Q, K] int64, distances [G, Q, K] f32), nearest first.
    """
    _check_method(method)
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


def grid_cell_table(database: torch.Tensor, cell_size: float,
                    grid_hw: Tuple[int, int], cell_capacity: int
                    ) -> torch.Tensor:
    """[G, gh, gw, C] int64 table of database indices per grid cell, -1 in
    the empty slots (JAX knn_grid_window's table).

    Each point's cell is floor(position / cell_size), clipped to the grid;
    a cell keeps its first `cell_capacity` points in index order (a stable
    sort of the cell ids, then the rank within the cell) and drops the
    rest."""
    gh, gw = grid_hw
    g, n, _ = database.shape
    cells = gh * gw
    dev = database.device
    cy = torch.clamp(torch.floor(database[..., 0] / cell_size), 0, gh - 1)
    cx = torch.clamp(torch.floor(database[..., 1] / cell_size), 0, gw - 1)
    cell = (cy * gw + cx).long()                                   # [G, N]
    key = (cell + torch.arange(g, device=dev)[:, None] * cells).reshape(-1)
    key_s, order = torch.sort(key, stable=True)
    first = torch.searchsorted(key_s, key_s, right=False)
    rank = torch.arange(g * n, device=dev) - first
    keep = rank < cell_capacity
    table = torch.full((g * cells + 1, cell_capacity), -1, dtype=torch.long,
                       device=dev)
    # Overflow goes to the extra last row, which is dropped.
    rows = torch.where(keep, key_s, torch.full_like(key_s, g * cells))
    table[rows, rank.clamp(0, cell_capacity - 1)] = order % n
    return table[:-1].reshape(g, gh, gw, cell_capacity)


def knn_grid_window(queries: torch.Tensor, database: torch.Tensor, k: int,
                    *, norm: str = "l2", cell_size: float = 4.0,
                    grid_hw: Tuple[int, int] = (120, 160),
                    window_radius: int = 8, cell_capacity: int = 8,
                    method: str = "exact"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spatial-hash KNN: exact within the (2R+1)^2-cell window around each
    query, for G databases at once (JAX: knn_grid_window, vmapped).

    The database points are binned into the grid's cells (`grid_cell_table`:
    at most `cell_capacity` per cell, the overflow dropped); query q, the
    centre of cell q of the row-major grid, takes the K nearest of the
    points in the cells of its window, clipped to the grid.  Exact KNN when
    R * cell_size covers the largest displacement and no cell overflows.

    Args:
      queries: [Q, 2] (y, x), Q = gh * gw, the row-major cell centres.
      database: [G, N, 2].

    Returns:
      (indices [G, Q, K] int64, distances [G, Q, K] f32), nearest first;
      slots beyond the window's candidates get distance +inf and index 0.
    """
    _check_method(method)
    gh, gw = grid_hw
    q = queries.shape[0]
    if q != gh * gw:
        raise ValueError(f"{q} queries for a {gh} x {gw} grid")
    if norm not in ("l2", "l1"):
        raise ValueError(f"unknown dist norm {norm!r}")
    g, n, _ = database.shape
    r, c = window_radius, cell_capacity
    dev = database.device
    table = grid_cell_table(database, cell_size, grid_hw, c)
    # The table with R cells of -1 around it, flat: [G, P, C].
    padded = torch.nn.functional.pad(table, (0, 0, r, r, r, r), value=-1)
    pw = gw + 2 * r
    padded = padded.reshape(g, -1, c)
    # Flat padded cell of window slot w = dy * (2R + 1) + dx of each query.
    qy = torch.arange(q, device=dev) // gw
    qx = torch.arange(q, device=dev) % gw
    span = torch.arange(2 * r + 1, device=dev)
    win = ((qy[:, None, None] + span[None, :, None]) * pw
           + qx[:, None, None] + span[None, None, :]).reshape(q, -1)
    cand_n = win.shape[1] * c
    block = max(1, min(q, GRID_BLOCK_ELEMS // max(g * cand_n, 1)))
    idx_out, dist_out = [], []
    for q0 in range(0, q, block):
        wb = win[q0:q0 + block]                                    # [Qb, W2]
        qb = wb.shape[0]
        cand = padded[:, wb.reshape(-1)].reshape(g, qb, cand_n)   # [G, Qb, WC]
        valid = cand >= 0
        cand = torch.where(valid, cand, torch.zeros_like(cand))
        pts = torch.gather(database, 1, cand.reshape(g, -1, 1).expand(
            -1, -1, 2)).reshape(g, qb, cand_n, 2)
        diff = pts - queries[q0:q0 + qb][None, :, None, :]
        dist = (diff * diff).sum(-1) if norm == "l2" else diff.abs().sum(-1)
        dist = torch.where(valid, dist, torch.full_like(dist, float("inf")))
        nd, pos = torch.topk(dist, k, dim=-1, largest=False, sorted=True)
        idx_out.append(torch.gather(cand, 2, pos))
        dist_out.append(nd)
    return torch.cat(idx_out, dim=1), torch.cat(dist_out, dim=1)


def knn_batched(queries: torch.Tensor, database: torch.Tensor, k: int, *,
                norm: str = "l2", method: str = "exact"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KNN with leading batch dims: queries [..., Q, D], database
    [..., N, D] -> (indices, distances) [..., Q, K], each batch entry's
    queries against its own database."""
    batch_shape = queries.shape[:-2]
    if database.shape[:-2] != batch_shape:
        raise ValueError(f"batch dims differ: {tuple(queries.shape)} vs "
                         f"{tuple(database.shape)}")
    fq = queries.reshape((-1,) + queries.shape[-2:])
    fd = database.reshape((-1,) + database.shape[-2:])
    pairs = [knn_blocked(qi, di[None], k, norm=norm, method=method)
             for qi, di in zip(fq, fd)]
    idx = torch.cat([p[0] for p in pairs])
    dist = torch.cat([p[1] for p in pairs])
    return (idx.reshape(batch_shape + idx.shape[-2:]),
            dist.reshape(batch_shape + dist.shape[-2:]))

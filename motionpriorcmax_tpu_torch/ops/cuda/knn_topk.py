"""Exact K nearest neighbours with the distance and the top-K fused: the
Hopper kernel and its plain version.

The focus loss's KNN over all database points (ops/knn.py::knn_blocked).
It replaces no TPU kernel: the JAX package leaves this to XLA's
`lax.top_k`.  The CUDA source is `motionpriorcmax_tpu_torch/csrc/
knn_topk.cu`; its header gives the bound and the design.

  knn_topk(queries, database, k, norm)       the launching call (counted)
  knn_topk_plain(queries, database, k, norm)  the same function in PyTorch:
                                              expanded-form distance blocks,
                                              torch.topk, refinement
  pairwise_dist(queries, database, norm)      the values both rank by

Both rank squared-l2 distances by the expanded form |q|^2 - 2 q.db + |db|^2
in full f32 (TF32 would round pixel coordinates of ~640 to errors of
hundreds of px^2; `torch.cdist` ranks near-ties differently) and refine the
K selected ones by direct subtraction; l1 distances are ranked as they are.
The kernel breaks ties at the K-th value toward the lower database index;
`torch.topk` makes its own choice there.

On a CUDA tensor `knn_topk` runs the kernel or raises; on a CPU tensor it
runs the plain version.  Any K <= N runs: K above 64 in passes of 64
neighbours, one kernel launch each.  `.launches` counts calls that
launched.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ...device import no_tf32

NORMS = ("l2", "l1")
# Distance entries per block of the plain version: queries are processed in
# blocks of max(1, PLAIN_BLOCK_ELEMS // (G * N)) rows, bounding the
# [G, block, N] distance tensor (and the top-k's scratch) to ~1 GiB of f32.
PLAIN_BLOCK_ELEMS = 1 << 28


def _check(queries: torch.Tensor, database: torch.Tensor, k: int,
           norm: str) -> None:
    if (queries.dim() != 2 or database.dim() != 3
            or queries.shape[1] != database.shape[2]):
        raise ValueError(f"queries must be [Q, D] and database [G, N, D], "
                         f"got {tuple(queries.shape)} and "
                         f"{tuple(database.shape)}")
    if queries.dtype != torch.float32 or database.dtype != torch.float32:
        raise TypeError(f"queries and database must be float32, got "
                        f"{queries.dtype} and {database.dtype}")
    if queries.device != database.device:
        raise ValueError(f"queries on {queries.device}, database on "
                         f"{database.device}")
    if norm not in NORMS:
        raise ValueError(f"unknown dist norm {norm!r} (l2, l1)")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")


def pairwise_dist(queries: torch.Tensor, database: torch.Tensor,
                  norm: str) -> torch.Tensor:
    """[Cq, D] x [G, N, D] -> [G, Cq, N] squared-l2 (expanded form) or l1
    distances, the values the plain version and the kernel rank by.  Call
    it with TF32 off (`device.no_tf32`)."""
    if norm == "l2":
        qq = torch.sum(queries * queries, dim=-1)[None, :, None]  # [1, Cq, 1]
        dd = torch.sum(database * database, dim=-1)[:, None, :]  # [G, 1, N]
        cross = torch.matmul(queries[None], database.transpose(1, 2))
        return qq - 2.0 * cross + dd
    if norm == "l1":
        return (queries[None, :, None, :]
                - database[:, None, :, :]).abs().sum(-1)
    raise ValueError(f"unknown dist norm {norm!r} (l2, l1)")


def knn_topk_plain(queries: torch.Tensor, database: torch.Tensor, k: int,
                   *, norm: str = "l2") -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices [G, Q, K] int64, distances [G, Q, K] f32), K = min(k, N),
    nearest first (plain): `pairwise_dist` over blocks of queries,
    torch.topk, and for l2 the K distances refined by direct subtraction."""
    _check(queries, database, k, norm)
    g, n, d = database.shape
    q = queries.shape[0]
    k = min(k, n)
    block = max(1, min(q, PLAIN_BLOCK_ELEMS // max(g * n, 1)))
    idx_out, dist_out = [], []
    with no_tf32():
        for q0 in range(0, q, block):
            qb = queries[q0:q0 + block]
            dist = pairwise_dist(qb, database, norm)
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


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built library's C entry point, argument types declared."""
    from .build import load_library

    lib = load_library("knn_topk")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.knn_topk
    fn.restype = i
    fn.argtypes = [p, p, p, p, i, i, i, i, i, p]
    return fn


def knn_topk(queries: torch.Tensor, database: torch.Tensor, k: int, *,
             norm: str = "l2") -> Tuple[torch.Tensor, torch.Tensor]:
    """K nearest database points of each query, for G databases at once.

    Args:
      queries: [Q, D] f32 query coordinates (shared by all databases).
      database: [G, N, D] f32 database coordinates.
      k: neighbours; K = min(k, N) are returned.
      norm: 'l2' (squared euclidean) or 'l1'.

    Returns:
      (indices [G, Q, K] int64, distances [G, Q, K] f32), nearest first.

    A CPU tensor runs the plain version.  A CUDA tensor launches the kernel
    on the current stream, or raises unless D = 2 and both tensors are
    contiguous and 8-byte aligned.
    """
    _check(queries, database, k, norm)
    if queries.device.type == "cpu":
        return knn_topk_plain(queries, database, k, norm=norm)
    g, n, d = database.shape
    if d != 2:
        raise ValueError(f"the kernel takes 2-D points, got D = {d}")
    if not (queries.is_contiguous() and database.is_contiguous()):
        raise ValueError("queries and database must be contiguous")
    if queries.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got "
                         f"{queries.device}")
    if queries.data_ptr() % 8 or database.data_ptr() % 8:
        raise ValueError("queries and database must be 8-byte aligned")
    k = min(k, n)
    q = queries.shape[0]
    idx = torch.empty(g, q, k, dtype=torch.int64, device=queries.device)
    dist = torch.empty(g, q, k, dtype=torch.float32, device=queries.device)
    if idx.numel() == 0:
        return idx, dist
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        err = _kernel()(queries.data_ptr(), database.data_ptr(),
                        idx.data_ptr(), dist.data_ptr(), g, q, n, k,
                        int(norm == "l1"), stream)
    if err != 0:
        raise RuntimeError(f"knn_topk kernel failed: cudaError_t {err}")
    knn_topk.launches += 1
    return idx, dist


knn_topk.launches = 0

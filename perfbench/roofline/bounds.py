"""Least times of the port's kernels, from the bytes and operations their
inputs need (the kernel table's bounds: each needed input byte read once,
each output byte written once, at the card's HBM rate).

Each function gives the bytes of one call from its shapes and the batch's
live-event counts, which the benchmark counts from the batch it made.
`least_seconds` turns bytes and f32 operations into the larger of the two
times.  A bound that depends on data the benchmark cannot see in a traced
run (the interpolation's nonzero pairs, the lookup's in-range windows) is
not here: those kernels stay out of `kernel_roofline`.
"""

from __future__ import annotations

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12            # f32 outside the tensor cores


def least_seconds(nbytes: float, flops: float = 0.0,
                  bytes_per_s: float = H100_BYTES_PER_S,
                  flops_per_s: float = H100_F32_FLOPS) -> float:
    return max(nbytes / bytes_per_s, flops / flops_per_s)


def iwe_vote_fwd(b: int, m: int, live: int, h: int, w: int) -> float:
    """One polarity half: every weight read, the coordinates of the live
    events, the images written."""
    return b * m * 4 + live * 8 + b * h * w * 4


def iwe_vote_bwd(b: int, m: int, live: int, h: int, w: int) -> float:
    """The forward's reads and the image cotangent, d coords written."""
    return b * m * 4 + live * 8 + b * h * w * 4 + b * m * 8


def lut_gather_fwd(b: int, m: int, cells: int, c: int) -> float:
    """Row and column of every event, its C values written, the LUT read."""
    return b * m * 8 + b * m * c * 4 + b * cells * c * 4


def lut_segsum_bwd(b: int, m: int, cells: int, segments: int, c: int
                   ) -> float:
    """Every event's cotangent, the run ends, d LUT written."""
    return b * m * c * 4 + b * segments * cells * 4 + b * cells * c * 4


def voxel_vote(b: int, m: int, nbins: int, h: int, w: int) -> float:
    """Every event row read, the grids written."""
    return b * m * 6 * 4 + b * nbins * h * w * 4


def focus_loss_step(b: int, m: int, npos: int, live: tuple, h: int, w: int,
                    cells: int, cell_sorted: bool) -> dict:
    """Least seconds per training step of the focus loss's port calls:
    the vote forward and backward over both polarity halves (`live` the
    live events of each) and, on cell-sorted events, the LUT gather and
    its sorted segment sum (2 values per event, 2 segments)."""
    halves = ((npos, live[0]), (m - npos, live[1]))
    out = {"iwe_vote_fwd": sum(least_seconds(iwe_vote_fwd(b, mm, ll, h, w))
                               for mm, ll in halves),
           "iwe_vote_bwd": sum(least_seconds(iwe_vote_bwd(b, mm, ll, h, w))
                               for mm, ll in halves)}
    if cell_sorted:
        out["lut_gather_fwd"] = least_seconds(lut_gather_fwd(b, m, cells, 2))
        out["lut_segsum_bwd"] = least_seconds(lut_segsum_bwd(b, m, cells, 2,
                                                             2))
    return out


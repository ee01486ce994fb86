"""Flow-LUT gather and its sorted segment-sum backward: the Hopper kernels
and their plain versions.

Port of the TPU kernel `motionpriorcmax_tpu/ops/pallas/lut_gather.py::
lut_gather_sorted`, which is both the event warp's LUT lookup
(`ops/events.py::_grid_gather_fwd`) and the boundary gather of its backward
(`ops/events.py::_segment_sum_sorted_batch_pallas`).  The port's backward is
one segmented reduction over the host-computed `cell_ends` instead of a
cumsum and a boundary gather.  The CUDA source is
`motionpriorcmax_tpu_torch/csrc/lut_gather.cu`; its header gives the bound
and the design.

  lut_gather(lut, rows, cols, cell_ends)  the differentiable lookup
  lut_gather_fwd / lut_segsum_bwd         the launching calls (counted)
  lut_gather_plain / lut_segsum_plain     the same functions in PyTorch
  lut_segsum_tiled_plain                  the segment sum as the kernel
                                          partitions it (tiles, pieces)

On a CUDA tensor the launching calls run their kernels or raise; on a CPU
tensor they run the plain version.  `.launches` counts calls that launched:
`lut_segsum_bwd` makes two device launches per call (pieces, then tiles)
and counts one.
"""

from __future__ import annotations

import bisect
import ctypes
import functools

import torch

# Channel counts the segment-sum kernel is built for (2 per reference time).
SEGSUM_CHANNELS = (1, 2, 4, 6, 8)
# The segment-sum kernel's partition (csrc/lut_gather.cu: kTile, kPiece,
# kWindowFloats): cells per block, events per piece, floats per
# shared-memory window.
TILE_CELLS = 512
PIECE_EVENTS = 4096
WINDOW_FLOATS = 2048


def _check_gather(lut, rows, cols):
    if lut.dim() != 4:
        raise ValueError(f"lut must be [B, R, X, C], got {tuple(lut.shape)}")
    if rows.dim() != 2 or rows.shape != cols.shape or rows.shape[0] != lut.shape[0]:
        raise ValueError(f"rows/cols must both be [B={lut.shape[0]}, M], got "
                         f"{tuple(rows.shape)} and {tuple(cols.shape)}")
    if lut.dtype != torch.float32:
        raise TypeError("lut must be float32")
    if rows.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError("rows and cols must be int32")
    if len({lut.device, rows.device, cols.device}) != 1:
        raise ValueError("lut, rows and cols on different devices")


def _check_segsum(g, cell_ends, cells):
    if g.dim() != 3 or g.dtype != torch.float32:
        raise ValueError(f"g must be float32 [B, M, C], got {g.dtype} "
                         f"{tuple(g.shape)}")
    if (cell_ends.dim() != 2 or cell_ends.shape[0] != g.shape[0]
            or cell_ends.shape[1] % cells != 0 or cell_ends.shape[1] == 0):
        raise ValueError(f"cell_ends must be [B, S * {cells}], got "
                         f"{tuple(cell_ends.shape)}")
    if cell_ends.dtype != torch.int32:
        raise TypeError("cell_ends must be int32")
    if g.device != cell_ends.device:
        raise ValueError("g and cell_ends on different devices")


def lut_gather_plain(lut: torch.Tensor, rows: torch.Tensor,
                     cols: torch.Tensor) -> torch.Tensor:
    """out[b, e, :] = lut[b, rows[b, e], cols[b, e], :] (plain).

    Indices are clamped into range, as the kernel does; in-range indices
    are the caller's contract."""
    _check_gather(lut, rows, cols)
    b, r, x, c = lut.shape
    flat = rows.long().clamp(0, r - 1) * x + cols.long().clamp(0, x - 1)
    return torch.gather(lut.reshape(b, r * x, c), 1,
                        flat[..., None].expand(-1, -1, c))


def lut_segsum_plain(g: torch.Tensor, cell_ends: torch.Tensor,
                     cells: int) -> torch.Tensor:
    """d lut [B, cells, C] = per-cell sums of g [B, M, C] over the S sorted
    runs given by cell_ends [B, S * cells] (plain).

    Entry j covers events [ends[j-1], ends[j]) (ends[-1] = 0), so the first
    cell of segment s starts at the last end of segment s - 1.  Computed as
    differences of a float64 running sum: every cell's sum is exact to f32
    rounding, like the kernel's per-cell sum."""
    _check_segsum(g, cell_ends, cells)
    b, m, c = g.shape
    csum = torch.cat([torch.zeros(b, 1, c, dtype=torch.float64, device=g.device),
                      torch.cumsum(g.double(), dim=1)], dim=1)    # [B, M+1, C]
    ends = cell_ends.long().clamp(0, m)
    # Run j is [lo, max(lo, end_j)), lo = end_{j-1}: the kernel's clamps.
    lo = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], dim=1)
    hi = torch.maximum(ends, lo)

    def at(idx):
        return torch.gather(csum, 1, idx[..., None].expand(-1, -1, c))

    segs = at(hi) - at(lo)
    return segs.reshape(b, -1, cells, c).sum(dim=1).float()


def _piece_ceil(a: int, piece: int) -> int:
    return -(-a // piece) * piece


def _skip_carried(e, pos: int, hi: int, piece: int) -> int:
    """csrc/lut_gather.cu::skip_carried: pos moved past the events that the
    pieces carry (from the first multiple of `piece` of their run on), or
    `hi` when no first-part event is left in [pos, hi)."""
    while pos < hi:
        i = bisect.bisect_right(e, pos) - 1        # the run holding pos
        if pos < _piece_ceil(e[i], piece):
            return pos
        nxt = e[i + 1] if i + 1 < len(e) else hi
        pos = nxt if nxt > pos else hi
    return hi


def _windows(tile_ends, cap: int, piece: int):
    """csrc/lut_gather.cu::next_window: the block's walk over its tile,
    (segment, first event, end) of windows of at most `cap` events."""
    s, pos = 0, tile_ends[0][0]
    while s < len(tile_ends):
        e = tile_ends[s]
        hi = max(e[-1], e[0])
        pos = _skip_carried(e, max(pos, e[0]), hi, piece)
        if pos < hi:
            end = min(pos + cap, hi)
            yield s, pos, end
            pos = end
            continue
        s += 1
        if s < len(tile_ends):
            pos = tile_ends[s][0]


def lut_segsum_tiled_plain(g: torch.Tensor, cell_ends: torch.Tensor,
                           cells: int, tile: int = TILE_CELLS,
                           piece: int = PIECE_EVENTS, window: int = 0):
    """lut_segsum_plain computed as the kernel partitions the work (plain):
    returns (d lut [B, cells, C] f32, coverage int64 [B, M]).

    The events of a sample are cut at every multiple of `piece`; a piece's
    carry is the sum of its events that belong to the run holding its first
    event.  A tile of `tile` consecutive cells walks each segment's span in
    windows of at most `window` events (default: the kernel's for C),
    skipping the carried events, and adds each run's first part (its events
    before its first multiple of `piece`) window by window, then the
    carries of the pieces the run heads, in piece order.  Partial sums are
    taken in float64 and rounded to f32 once, then combined in f32 in the
    kernel's order.  The coverage counts how many times each event was
    added: 1 up to the last end, 0 after.
    """
    _check_segsum(g, cell_ends, cells)
    b, m, c = g.shape
    cap = window or (WINDOW_FLOATS - 8) // c
    segs = cell_ends.shape[1] // cells
    csum = torch.cat([torch.zeros(b, 1, c, dtype=torch.float64),
                      torch.cumsum(g.detach().cpu().double(), dim=1)], dim=1)
    ends = cell_ends.long().clamp(0, m).cpu().tolist()
    dlut = torch.zeros(b, cells, c, dtype=torch.float32)
    marks = torch.zeros(b, m + 1, dtype=torch.int64)
    pieces = -(-m // piece)
    for bi in range(b):
        eb = ends[bi]
        carry = []
        for q in range(pieces):
            x = q * piece
            j = bisect.bisect_right(eb, x)              # the head run
            stop = max(min(eb[j], x + piece, m), x) if j < len(eb) else x
            carry.append((csum[bi, stop] - csum[bi, x]).float())
            marks[bi, x] += 1
            marks[bi, stop] -= 1
        for j0 in range(0, cells, tile):
            tile_ends = [[0 if s == 0 and j0 - 1 + i < 0
                          else eb[s * cells + min(j0 - 1 + i, cells - 1)]
                          for i in range(tile + 1)] for s in range(segs)]
            acc = torch.zeros(tile, c, dtype=torch.float32)
            for s, w0, w1 in _windows(tile_ends, cap, piece):
                e = torch.tensor(tile_ends[s])
                a = e[:-1]
                first = torch.minimum(torch.maximum(e[1:], a),
                                      -(-a // piece) * piece)
                lo = a.clamp(min=w0)
                hi = first.clamp(max=w1)
                live = hi > lo
                part = (csum[bi, hi.clamp(min=0)] - csum[bi, lo]).float()
                acc += torch.where(live[:, None], part, 0.0)
                marks[bi].index_add_(0, lo[live], torch.ones_like(lo[live]))
                marks[bi].index_add_(0, hi[live], -torch.ones_like(hi[live]))
            for i in range(min(tile, cells - j0)):
                for s in range(segs):
                    a = tile_ends[s][i]
                    stop = max(tile_ends[s][i + 1], a)
                    for q in range(_piece_ceil(a, piece) // piece,
                                   min(_piece_ceil(stop, piece) // piece,
                                       pieces)):
                        acc[i] += carry[q]
            dlut[bi, j0:j0 + tile] = acc[:min(tile, cells - j0)]
    return dlut.to(g.device), torch.cumsum(marks, dim=1)[:, :m]


@functools.lru_cache(maxsize=None)
def _kernels():
    """The built library's C entry points, argument types declared."""
    from .build import load_library

    lib = load_library("lut_gather")
    p, i = ctypes.c_void_p, ctypes.c_int
    fwd = lib.lut_gather_fwd
    fwd.restype = i
    fwd.argtypes = [p, p, p, p, i, i, i, i, i, p]
    bwd = lib.lut_segsum_bwd
    bwd.restype = i
    bwd.argtypes = [p, p, p, p, i, i, i, i, i, p]
    carry = lib.lut_segsum_carry_floats
    carry.restype = ctypes.c_longlong
    carry.argtypes = [i, i, i]
    return fwd, bwd, carry


def lut_gather_fwd(lut: torch.Tensor, rows: torch.Tensor,
                   cols: torch.Tensor) -> torch.Tensor:
    """[B, R, X, C] f32 LUT, [B, M] int32 rows/cols -> [B, M, C] f32.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    on the current stream or raises.
    """
    _check_gather(lut, rows, cols)
    if lut.device.type != "cuda":
        return lut_gather_plain(lut, rows, cols)
    b, r, x, c = lut.shape
    m = rows.shape[1]
    lut, rows, cols = lut.contiguous(), rows.contiguous(), cols.contiguous()
    out = torch.empty(b, m, c, dtype=torch.float32, device=lut.device)
    fwd, _, _ = _kernels()
    with torch.cuda.device(lut.device):
        stream = torch.cuda.current_stream(lut.device).cuda_stream
        err = fwd(lut.data_ptr(), rows.data_ptr(), cols.data_ptr(),
                  out.data_ptr(), b, m, r, x, c, stream)
    if err != 0:
        raise RuntimeError(f"lut_gather_fwd kernel failed: cudaError_t {err}")
    lut_gather_fwd.launches += 1
    return out


def lut_segsum_bwd(g: torch.Tensor, cell_ends: torch.Tensor,
                   cells: int) -> torch.Tensor:
    """[B, M, C] f32 cotangents, [B, S * cells] int32 -> [B, cells, C] f32.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernels
    (pieces, then tiles) on the current stream or raises.
    """
    _check_segsum(g, cell_ends, cells)
    if g.device.type != "cuda":
        return lut_segsum_plain(g, cell_ends, cells)
    b, m, c = g.shape
    if c not in SEGSUM_CHANNELS:
        raise ValueError(f"the kernel sums {SEGSUM_CHANNELS} channels, "
                         f"got {c}")
    segs = cell_ends.shape[1] // cells
    g, cell_ends = g.contiguous(), cell_ends.contiguous()
    if g.data_ptr() % 16:                    # its windows copy 16 bytes
        g = g.clone()
    dlut = torch.empty(b, cells, c, dtype=torch.float32, device=g.device)
    _, bwd, carry_floats = _kernels()
    carry = torch.empty(carry_floats(b, m, c), dtype=torch.float32,
                        device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = bwd(g.data_ptr(), cell_ends.data_ptr(), carry.data_ptr(),
                  dlut.data_ptr(), b, cells, segs, m, c, stream)
    if err != 0:
        raise RuntimeError(f"lut_segsum_bwd kernel failed: cudaError_t {err}")
    lut_segsum_bwd.launches += 1
    return dlut


lut_gather_fwd.launches = 0
lut_segsum_bwd.launches = 0


class LutGather(torch.autograd.Function):
    """The lookup with the sorted segment sum as its gradient."""

    @staticmethod
    def forward(ctx, lut, rows, cols, cell_ends):
        ctx.save_for_backward(cell_ends)
        ctx.lut_shape = tuple(lut.shape)
        return lut_gather_fwd(lut, rows, cols)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        (cell_ends,) = ctx.saved_tensors
        b, r, x, c = ctx.lut_shape
        dlut = lut_segsum_bwd(g.contiguous(), cell_ends, r * x)
        return dlut.reshape(b, r, x, c), None, None, None


def lut_gather(lut: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
               cell_ends: torch.Tensor) -> torch.Tensor:
    """Differentiable out[b, e, :] = lut[b, rows[b, e], cols[b, e], :].

    The events must be sorted by flat cell id rows * X + cols within each
    of the S segments of cell_ends [B, S * R * X] (data/host_ops.py::
    lut_cell_sort); the gradient to lut is then the segment sum over those
    runs.  rows/cols [B, M] int32, pre-clipped to range.
    """
    return LutGather.apply(lut, rows, cols, cell_ends)

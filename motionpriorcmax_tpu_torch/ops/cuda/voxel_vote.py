"""Trilinear voxel vote of event rows: the Hopper kernel and its plain
version.

Port of the TPU kernel `motionpriorcmax_tpu/ops/pallas/voxel_vote.py::
voxel_vote_pallas_sorted`.  The port computes the exact f32 function of the
JAX scatter voxelizer (`motionpriorcmax_tpu/ops/events.py::
voxel_grid_from_events`), not the TPU kernel's bf16 tap tiles; events need
not be sorted.  Forward only: the grid is built from event data, nothing
differentiates through it.  The CUDA source is
`motionpriorcmax_tpu_torch/csrc/voxel_vote.cu`; its header gives the bound
and the design: the events are binned by shared-memory tile (all bins of
TY x TX pixels of one sample) and each voxel is summed by the thread that
owns its pixel, so every output element is written once and no atomic
touches a float.

  voxel_vote(events, num_bins, height, width)        the launch (counted)
  voxel_vote_plain(events, num_bins, height, width)  the same in PyTorch
  voxel_taps(events, num_bins, height, width)        the 8 taps per event
  voxel_tile_shape, voxel_event_tiles, voxel_tile_readers, voxel_tile_keeps,
  voxel_vote_tiled_plain                             the kernel's tiling
                                                     in PyTorch

On a CUDA tensor `voxel_vote` launches the kernel or raises; on a CPU
tensor it runs the plain version.  `.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch


def _check(events: torch.Tensor) -> None:
    if events.dim() != 3 or events.shape[-1] != 6:
        raise ValueError(f"events must be [B, M, 6], got {tuple(events.shape)}")
    if events.dtype != torch.float32:
        raise TypeError("events must be float32")


def _clamped(events: torch.Tensor, num_bins: int, height: int, width: int
             ) -> Tuple[torch.Tensor, ...]:
    """(value, y, x, t_norm) [B, M]: the vote value and the coordinates
    clamped to [-3, size + 2], as the kernel takes them."""
    value = (2.0 * events[..., 3] - 1.0) * events[..., 5]
    y = events[..., 0].clamp(-3.0, height + 2.0)
    x = events[..., 1].clamp(-3.0, width + 2.0)
    t = (events[..., 2] * (num_bins - 1)).clamp(-3.0, num_bins + 2.0)
    return value, y, x, t


def voxel_taps(events: torch.Tensor, num_bins: int, height: int, width: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flat index int64 [8, B, M] into [B * nbins * H * W], value f32
    [8, B, M]) of each event's eight taps; masked taps get index 0 and
    value 0.

    t_norm = t * (nbins - 1), value (2p - 1) * valid, floor / floor + 1 taps
    with weights 1 - |tap - coordinate| per axis, each axis masked to its
    range.  Coordinates are clamped to [-3, size + 2] first, where both taps
    stay outside the range as before, so the integer cast is defined for
    any input; the kernel does the same."""
    _check(events)
    b = events.shape[0]
    value, y, x, t = _clamped(events, num_bins, height, width)
    x0, y0, t0 = torch.floor(x), torch.floor(y), torch.floor(t)
    base = torch.arange(b, device=events.device)[:, None] * num_bins
    idx, val = [], []
    for dx in (0.0, 1.0):
        xi = x0 + dx
        wx = 1.0 - torch.abs(xi - x)
        mx = (xi >= 0) & (xi < width)
        for dy in (0.0, 1.0):
            yi = y0 + dy
            wy = 1.0 - torch.abs(yi - y)
            my = (yi >= 0) & (yi < height)
            for dt in (0.0, 1.0):
                ti = t0 + dt
                wt = 1.0 - torch.abs(ti - t)
                mask = mx & my & (ti >= 0) & (ti < num_bins)
                flat = (((base + ti.long()) * height + yi.long()) * width
                        + xi.long())
                idx.append(torch.where(mask, flat, torch.zeros_like(flat)))
                val.append(torch.where(mask, value * wx * wy * wt,
                                       torch.zeros_like(value)))
    return torch.stack(idx), torch.stack(val)


def voxel_vote_plain(events: torch.Tensor, num_bins: int, height: int,
                     width: int) -> torch.Tensor:
    """[B, M, 6] (y, x, t in [0, 1], p, bin, valid) -> [B, nbins, H, W] f32
    trilinear vote (plain)."""
    _check(events)
    idx, val = voxel_taps(events, num_bins, height, width)
    out = torch.zeros(events.shape[0] * num_bins * height * width,
                      dtype=torch.float32, device=events.device)
    out.index_add_(0, idx.reshape(-1), val.reshape(-1))
    return out.reshape(events.shape[0], num_bins, height, width)


# -- the kernel's tiling, and its plain twin ------------------------------------

# A tile is all nbins bins of TY x TX pixels of one sample, held in shared
# memory (kMaxTileFloats in csrc/voxel_vote.cu); TX is a multiple of 4.
MAX_TILE_FLOATS = 15360
# Categories of an event in its home tile (kInterior.. in the source): which
# neighbouring tiles also read its record.
INTERIOR, DOWN, BOTH, RIGHT = range(4)


def voxel_tile_shape(num_bins: int, height: int, width: int
                     ) -> Tuple[int, int]:
    """(TY, TX) of the kernel's tiles: 64 pixels wide and as many rows (at
    most 16) as fit nbins x TY x TX f32 in 60 KB; narrower when nbins is
    large.  15 bins: 16 x 64."""
    tx = 64
    if num_bins * tx > MAX_TILE_FLOATS:
        tx = MAX_TILE_FLOATS // num_bins // 4 * 4
    if tx < 4:
        raise ValueError(f"{num_bins} bins do not fit a shared-memory tile "
                         f"(at most {MAX_TILE_FLOATS // 4})")
    ty = max(1, min(16, MAX_TILE_FLOATS // (num_bins * tx)))
    return ty, tx


def voxel_event_tiles(events: torch.Tensor, num_bins: int, height: int,
                      width: int, ty: int, tx: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(live [B, M] bool, home tile [B, M] int64, category [B, M] int64): the
    kernel's classification of each event (`classify` in the source).

    Live: value != 0 and an in-range tap on every axis.  The home tile holds
    the event's first in-range x and y taps; the category says whether its
    taps also cross into the tile to the right (RIGHT), below (DOWN) or
    both (BOTH, and then into the one below-right too)."""
    _check(events)
    value, y, x, t = _clamped(events, num_bins, height, width)
    x0, y0, t0 = (torch.floor(c).long() for c in (x, y, t))
    live = ((value != 0) & (x0 >= -1) & (x0 < width) & (y0 >= -1)
            & (y0 < height) & (t0 >= -1) & (t0 < num_bins))
    cross_x = (x0 >= 0) & (x0 + 1 < width) & ((x0 + 1) % tx == 0)
    cross_y = (y0 >= 0) & (y0 + 1 < height) & ((y0 + 1) % ty == 0)
    tiles_x = -(-width // tx)
    home = (y0.clamp(min=0) // ty) * tiles_x + x0.clamp(min=0) // tx
    cat = torch.where(cross_y, torch.where(cross_x, BOTH, DOWN),
                      torch.where(cross_x, RIGHT, INTERIOR))
    return live, home, cat


def voxel_tile_readers(events: torch.Tensor, num_bins: int, height: int,
                       width: int, ty: int, tx: int) -> torch.Tensor:
    """[4, B, M] int64: the tiles whose accumulate step reads each event's
    record (-1: none), by the kernel's rule: a tile reads its own records,
    its left neighbour's BOTH and RIGHT, its upper neighbour's DOWN and
    BOTH and its upper-left neighbour's BOTH."""
    live, home, cat = voxel_event_tiles(events, num_bins, height, width, ty,
                                        tx)
    tiles_x = -(-width // tx)
    none = torch.full_like(home, -1)
    right = (cat == BOTH) | (cat == RIGHT)
    down = (cat == DOWN) | (cat == BOTH)
    return torch.stack([
        torch.where(live, home, none),
        torch.where(live & right, home + 1, none),
        torch.where(live & down, home + tiles_x, none),
        torch.where(live & (cat == BOTH), home + tiles_x + 1, none)])


def voxel_tap_in_range(events: torch.Tensor, num_bins: int, height: int,
                       width: int) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """(row [8, B, M], column [8, B, M], in range [8, B, M] bool) of the
    eight taps in `voxel_taps`' order; in range: inside the grid, of an
    event whose value is not 0."""
    value, y, x, t = _clamped(events, num_bins, height, width)
    x0, y0, t0 = (torch.floor(c).long() for c in (x, y, t))
    rows, cols, ok = [], [], []
    for dx in (0, 1):
        for dy in (0, 1):
            for dt in (0, 1):
                rows.append(y0 + dy)
                cols.append(x0 + dx)
                ok.append((x0 + dx >= 0) & (x0 + dx < width)
                          & (y0 + dy >= 0) & (y0 + dy < height)
                          & (t0 + dt >= 0) & (t0 + dt < num_bins)
                          & (value != 0))
    return torch.stack(rows), torch.stack(cols), torch.stack(ok)


def voxel_tile_keeps(events: torch.Tensor, num_bins: int, height: int,
                     width: int, ty: int, tx: int) -> torch.Tensor:
    """[4, 8, B, M] bool: whether reader tile r of `voxel_tile_readers`
    keeps tap i of the event (the tap lies inside that tile and the grid:
    `vote_into` in the source)."""
    readers = voxel_tile_readers(events, num_bins, height, width, ty, tx)
    rows, cols, in_range = voxel_tap_in_range(events, num_bins, height,
                                              width)
    tap_tile = (rows // ty) * -(-width // tx) + cols // tx
    return ((readers[:, None] >= 0) & (readers[:, None] == tap_tile[None])
            & in_range[None])


def voxel_vote_tiled_plain(events: torch.Tensor, num_bins: int, height: int,
                           width: int, ty: Optional[int] = None,
                           tx: Optional[int] = None) -> torch.Tensor:
    """The kernel's tiling in PyTorch: every tile sums the taps it keeps of
    the records it reads; the tiles together give [B, nbins, H, W] f32, the
    function of `voxel_vote_plain`."""
    if ty is None or tx is None:
        ty, tx = voxel_tile_shape(num_bins, height, width)
    keeps = voxel_tile_keeps(events, num_bins, height, width, ty, tx)
    idx, val = voxel_taps(events, num_bins, height, width)
    out = torch.zeros(events.shape[0] * num_bins * height * width,
                      dtype=torch.float32, device=events.device)
    for kept in keeps:                       # tile by tile of each reader
        out.index_add_(0, idx[kept], val[kept])
    return out.reshape(events.shape[0], num_bins, height, width)


@functools.lru_cache(maxsize=None)
def _library():
    """The built library's C entry points, argument types declared."""
    from .build import load_library

    lib = load_library("voxel_vote")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.voxel_vote.restype = i
    lib.voxel_vote.argtypes = [p, p, i, i, i, i, i, i, i, p, p, p]
    lib.voxel_vote_int_scratch.restype = ctypes.c_longlong
    lib.voxel_vote_int_scratch.argtypes = [i, i, i, i, i, i]
    lib.voxel_vote_setup.restype = i
    lib.voxel_vote_setup.argtypes = []
    return lib


@functools.lru_cache(maxsize=None)
def _setup(device_index: int) -> None:
    """The kernels' shared-memory limits, set once per device."""
    with torch.cuda.device(device_index):
        err = _library().voxel_vote_setup()
    if err != 0:
        raise RuntimeError(f"voxel_vote set-up failed: cudaError_t {err}")


def voxel_vote(events: torch.Tensor, num_bins: int, height: int,
               width: int) -> torch.Tensor:
    """[B, M, 6] event rows -> [B, nbins, H, W] f32 trilinear vote.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    on the current stream or raises.  The kernel needs B * M 16-byte
    records and a few int32 counters of scratch; it writes every output
    element once.
    """
    _check(events)
    if events.device.type != "cuda":
        return voxel_vote_plain(events, num_bins, height, width)
    events = events.contiguous()
    bsz, m, _ = events.shape
    ty, tx = voxel_tile_shape(num_bins, height, width)
    lib = _library()
    dev = events.device
    _setup(dev.index)
    out = torch.empty(bsz, num_bins, height, width, dtype=torch.float32,
                      device=dev)
    # One scratch buffer: the 16-byte records, then the int32 counters.
    rec_bytes = bsz * m * 16
    n_ints = lib.voxel_vote_int_scratch(bsz, m, height, width, ty, tx)
    scratch = torch.empty(rec_bytes + 4 * n_ints, dtype=torch.uint8,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.voxel_vote(events.data_ptr(), out.data_ptr(), bsz, m,
                             num_bins, height, width, ty, tx,
                             scratch.data_ptr(),
                             scratch.data_ptr() + rec_bytes, stream)
    if err != 0:
        raise RuntimeError(f"voxel_vote kernel failed: cudaError_t {err}")
    voxel_vote.launches += 1
    return out


voxel_vote.launches = 0

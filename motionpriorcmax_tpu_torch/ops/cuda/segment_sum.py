"""Any-order segment sum over the flow LUT, the backward of the LUT gather
for events in any order: the Hopper kernel and its plain version.

Port of the TPU kernel `motionpriorcmax_tpu/ops/pallas/iwe_vote.py::
segment_sum_pallas`, the backward of `ops/events.py::grid_gather` when the
events are not cell-sorted.  The port computes the exact f32 function of
the JAX 'native' scatter, not the TPU kernel's bf16 tap tiles.  The CUDA
source is `motionpriorcmax_tpu_torch/csrc/segment_sum.cu`; its header
gives the bound and the design.

  grid_gather_any_order(grid, rows, cols)  the differentiable lookup
  grid_segment_sum                         the launch (counted)
  segment_sum_plain                        the same function in PyTorch

On a CUDA tensor `grid_segment_sum` launches its kernel or raises; on a CPU
tensor it runs the plain version.  `.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Channel counts the kernel is built for (2 per reference time).
CHANNELS = (1, 2, 4, 6, 8)


def _check(rows, cols, g):
    if rows.dim() != 2 or rows.shape != cols.shape:
        raise ValueError(f"rows/cols must both be [B, M], got "
                         f"{tuple(rows.shape)} and {tuple(cols.shape)}")
    if g.dim() != 3 or tuple(g.shape[:2]) != tuple(rows.shape):
        raise ValueError(f"g must be [B, M, C] with [B, M] = "
                         f"{tuple(rows.shape)}, got {tuple(g.shape)}")
    if rows.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError("rows and cols must be int32")
    if g.dtype != torch.float32:
        raise TypeError("g must be float32")
    if len({rows.device, cols.device, g.device}) != 1:
        raise ValueError("rows, cols and g on different devices")


def segment_sum_plain(rows: torch.Tensor, cols: torch.Tensor,
                      g: torch.Tensor, num_rows: int, num_cols: int
                      ) -> torch.Tensor:
    """out[b, r, x, :] = sum of g[b, e, :] over the events e with
    rows[b, e] == r and cols[b, e] == x, f32 (plain).

    Indices are clamped into range, as the kernel does; in-range indices
    are the caller's contract."""
    _check(rows, cols, g)
    b, m, c = g.shape
    out = torch.zeros(b, num_rows, num_cols, c, dtype=torch.float32,
                      device=g.device)
    bi = torch.arange(b, device=g.device)[:, None].expand(b, m)
    out.index_put_((bi, rows.long().clamp(0, num_rows - 1),
                    cols.long().clamp(0, num_cols - 1)), g, accumulate=True)
    return out


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built library's C entry point, argument types declared."""
    from .build import load_library

    lib = load_library("segment_sum")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.grid_segment_sum
    fn.restype = i
    fn.argtypes = [p, p, p, p, i, i, i, i, i, p]
    return fn


def grid_segment_sum(rows: torch.Tensor, cols: torch.Tensor, g: torch.Tensor,
                     num_rows: int, num_cols: int) -> torch.Tensor:
    """[B, M] int32 rows/cols, [B, M, C] f32 -> [B, R, X, C] f32.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    on the current stream or raises.
    """
    _check(rows, cols, g)
    if g.device.type != "cuda":
        return segment_sum_plain(rows, cols, g, num_rows, num_cols)
    b, m, c = g.shape
    if c not in CHANNELS:
        raise ValueError(f"the kernel sums {CHANNELS} channels, got {c}")
    # The kernel loads 16 bytes at a time: a view off that alignment is
    # copied.
    rows, cols, g = (t if t.data_ptr() % 16 == 0 else t.clone()
                     for t in (rows.contiguous(), cols.contiguous(),
                               g.contiguous()))
    out = torch.zeros(b, num_rows, num_cols, c, dtype=torch.float32,
                      device=g.device)
    fn = _kernel()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = fn(rows.data_ptr(), cols.data_ptr(), g.data_ptr(),
                 out.data_ptr(), b, m, num_rows, num_cols, c, stream)
    if err != 0:
        raise RuntimeError(f"grid_segment_sum kernel failed: cudaError_t {err}")
    grid_segment_sum.launches += 1
    return out


grid_segment_sum.launches = 0


class GridGatherAnyOrder(torch.autograd.Function):
    """grid[b, rows, cols, :] for events in any order; the gradient to the
    grid is the any-order segment sum."""

    @staticmethod
    def forward(ctx, grid, rows, cols):
        ctx.save_for_backward(rows, cols)
        ctx.grid_shape = tuple(grid.shape)
        b, r, x, c = grid.shape
        flat = rows.long() * x + cols.long()
        return torch.gather(grid.reshape(b, r * x, c), 1,
                            flat[..., None].expand(-1, -1, c))

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        rows, cols = ctx.saved_tensors
        _, r, x, _ = ctx.grid_shape
        return grid_segment_sum(rows, cols, g.contiguous(), r, x), None, None


def grid_gather_any_order(grid: torch.Tensor, rows: torch.Tensor,
                          cols: torch.Tensor) -> torch.Tensor:
    """Differentiable out[b, e, :] = grid[b, rows[b, e], cols[b, e], :].

    grid [B, R, X, C] f32, rows/cols [B, M] int32 pre-clipped to range, in
    any order; the gradient to grid runs `grid_segment_sum`.
    """
    return GridGatherAnyOrder.apply(grid, rows, cols)

"""flax's BatchNorm over NCHW, with an optional fused ReLU: the Hopper
kernels, their plain versions, and the autograd Function that
`models/norm.py::FlaxBatchNorm2d` runs.

It replaces no TPU kernel: the JAX package leaves the norm to XLA's
fusion.  The CUDA source is `motionpriorcmax_tpu_torch/csrc/
flax_batch_norm.cu`; its header gives the bound and the design.

  flax_batch_norm(x, weight, bias, ...)   the differentiable norm
  flax_bn_reduce(x, dy=None, coef=None)   per-channel sums (counted): Σx
                                          and Σx² (forward), or Σg and
                                          Σg (x - mean) (backward)
  flax_bn_apply(x, coef, relu, dy=None)   the elementwise pass (counted):
                                          y, or dx (each op rounded as
                                          the plain version rounds it:
                                          the same bits from the same
                                          coef)
  reduce_plain, apply_plain               the same functions in PyTorch

The arithmetic is flax's (models/norm.py): statistics over (N, H, W) in
f32, mean = E[x], var = max(0, E[x^2] - E[x]^2), biased in the running
statistics too; y = (x - mean) * (rsqrt(var + eps) * weight) + bias in
f32, cast to the input's dtype, then the ReLU where fused.  The backward
is its closed form, g the output's cotangent (zero where the fused ReLU's
output is not positive), n the batch's element count per channel,
r = rsqrt(var + eps), x^ = (x - mean) r:

  dx = weight r (g - Σg / n - x^ Σ(g x^) / n)    train mode; the last
                                                 term 0 where the clamp
                                                 cut the variance
  dx = weight r g                                eval mode
  dweight = Σ g x^,  dbias = Σ g

A float64 input computes in float64 (the plain version only), every
other dtype in float32.  The C-length statistics (mean, var, rsqrt, the
running update, the group sum of `stats_sum`) are torch ops between the
launches.  On a CPU tensor the wrappers run their plain versions; on a
CUDA tensor (bf16 or f32, NCHW-contiguous) the kernels, or they raise.
`.launches` counts kernel launches: 2 per `flax_bn_reduce` call, 1 per
`flax_bn_apply` call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import torch

# Elements of a channel's (sample, pixel) sequence per block; the kernels'
# kBlockElems (checked against the library on first use).
BLOCK_ELEMS = 8192
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """float64 for float64 inputs, float32 for every other dtype."""
    return torch.promote_types(dtype, torch.float32)


def _check(x: torch.Tensor, dy: Optional[torch.Tensor],
           coef: Optional[torch.Tensor], rows: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be NCHW, got {tuple(x.shape)}")
    if dy is not None and (dy.shape != x.shape or dy.dtype != x.dtype
                           or dy.device != x.device):
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} on {dy.device} "
                         f"does not match x {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")
    if coef is not None and (tuple(coef.shape) != (rows, x.shape[1])
                             or coef.device != x.device):
        raise ValueError(f"coef must be [{rows}, {x.shape[1]}] on "
                         f"{x.device}, got {tuple(coef.shape)} on "
                         f"{coef.device}")


def _kernel_args(x: torch.Tensor, *others: torch.Tensor):
    """Raise unless the kernels take x (and the same-shaped others); the
    launch's (dtype code, n, c, hw, blocks per channel)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"the kernels take float32 or bfloat16, got "
                        f"{x.dtype}")
    if not all(t.is_contiguous() for t in (x, *others)):
        raise ValueError("x (and dy) must be NCHW-contiguous")
    n, c, h, w = x.shape
    hw = h * w
    if n * hw >= (1 << 31) - BLOCK_ELEMS or c > 65535 or x.numel() == 0:
        raise ValueError(f"the kernels take 0 < N H W < 2^31 - 8192 and "
                         f"C <= 65535, got {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"the kernels run on CUDA tensors, got {x.device}")
    return _DTYPES[x.dtype], n, c, hw, -(-n * hw // BLOCK_ELEMS)


def _out(d: torch.Tensor, coef: torch.Tensor, dtype: torch.dtype,
         relu: bool) -> torch.Tensor:
    """(x - mean) -> the forward's output, as the kernels round it."""
    y = (d * coef[1, :, None, None] + coef[2, :, None, None]).to(dtype)
    return torch.relu(y) if relu else y


def reduce_plain(x: torch.Tensor, dy: Optional[torch.Tensor] = None,
                 coef: Optional[torch.Tensor] = None,
                 relu: bool = False) -> torch.Tensor:
    """[2, C] per-channel sums over (N, H, W) (plain): Σx and Σx², or with
    dy and coef ([3, C]: mean, mul, bias) Σg and Σg (x - mean)."""
    xf = x.to(compute_dtype(x.dtype))
    if dy is None:
        return torch.stack([xf.sum(dim=(0, 2, 3)),
                            (xf * xf).sum(dim=(0, 2, 3))])
    d = xf - coef[0, :, None, None]
    g = dy.to(xf.dtype)
    if relu:
        g = torch.where(_out(d, coef, x.dtype, True) > 0, g, 0.0)
    return torch.stack([g.sum(dim=(0, 2, 3)), (g * d).sum(dim=(0, 2, 3))])


def apply_plain(x: torch.Tensor, coef: torch.Tensor, relu: bool,
                dy: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward's output (coef [3, C]: mean, mul, bias), or with dy the
    backward's dx (coef [5, C]: and gmean, k), in x's dtype (plain)."""
    d = x.to(compute_dtype(x.dtype)) - coef[0, :, None, None]
    if dy is None:
        return _out(d, coef, x.dtype, relu)
    g = dy.to(d.dtype)
    if relu:
        g = torch.where(_out(d, coef, x.dtype, True) > 0, g, 0.0)
    c = coef[:, :, None, None]
    return (c[1] * ((g - c[3]) - d * c[4])).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _library():
    """The built library, argument types declared."""
    from .build import load_library

    lib = load_library("flax_batch_norm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flax_bn_block_elems.restype = i
    lib.flax_bn_block_elems.argtypes = []
    if lib.flax_bn_block_elems() != BLOCK_ELEMS:
        raise RuntimeError("csrc/flax_batch_norm.cu's kBlockElems is not "
                           f"BLOCK_ELEMS = {BLOCK_ELEMS}")
    for name, args in (("flax_bn_stats", [p, p, p, i, i, i, i, i, p]),
                       ("flax_bn_bwd_reduce",
                        [p, p, p, p, p, i, i, i, i, i, i, p]),
                       ("flax_bn_apply", [p, p, p, i, i, i, i, i, i, p]),
                       ("flax_bn_bwd_apply",
                        [p, p, p, p, i, i, i, i, i, i, p])):
        fn = getattr(lib, name)
        fn.restype = i
        fn.argtypes = args
    return lib


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def flax_bn_reduce(x: torch.Tensor, dy: Optional[torch.Tensor] = None,
                   coef: Optional[torch.Tensor] = None,
                   relu: bool = False) -> torch.Tensor:
    """[2, C] per-channel sums in the compute dtype: Σx and Σx², or, with
    the cotangent dy and coef ([3, C] f32: mean, mul, bias), Σg and
    Σg (x - mean), g = dy zeroed where the fused ReLU's output is not
    positive.  A CPU tensor runs the plain version; a CUDA tensor two
    launches (partial sums per block, then each channel's in a fixed
    order) or raises."""
    _check(x, dy, coef, 3)
    if x.device.type == "cpu":
        return reduce_plain(x, dy, coef, relu)
    args = _kernel_args(x, *(() if dy is None else (dy,)))
    dtype, n, c, hw, nblk = args
    part = torch.empty(2, c, nblk, dtype=torch.float64, device=x.device)
    out = torch.empty(2, c, dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        if dy is None:
            err = lib.flax_bn_stats(x.data_ptr(), part.data_ptr(),
                                    out.data_ptr(), *args, _stream(x))
        else:
            coef = coef.float().contiguous()
            err = lib.flax_bn_bwd_reduce(
                x.data_ptr(), dy.data_ptr(), coef.data_ptr(), part.data_ptr(),
                out.data_ptr(), dtype, int(relu), n, c, hw, nblk, _stream(x))
    if err != 0:
        raise RuntimeError(f"flax_bn_reduce kernels failed: cudaError_t {err}")
    flax_bn_reduce.launches += 2
    return out


flax_bn_reduce.launches = 0


def flax_bn_apply(x: torch.Tensor, coef: torch.Tensor, relu: bool,
                  dy: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward's output (coef [3, C] f32: mean, mul, bias) or, with dy,
    the backward's dx = mul (g - gmean - (x - mean) k) (coef [5, C]: and
    gmean, k), in x's dtype.  A CPU tensor runs the plain version; a CUDA
    tensor one launch or raises."""
    _check(x, dy, coef, 3 if dy is None else 5)
    if x.device.type == "cpu":
        return apply_plain(x, coef, relu, dy)
    dtype, n, c, hw, nblk = _kernel_args(x, *(() if dy is None else (dy,)))
    coef = coef.float().contiguous()
    out = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        if dy is None:
            err = lib.flax_bn_apply(x.data_ptr(), out.data_ptr(),
                                    coef.data_ptr(), dtype, int(relu), n, c,
                                    hw, nblk, _stream(x))
        else:
            err = lib.flax_bn_bwd_apply(
                x.data_ptr(), dy.data_ptr(), out.data_ptr(), coef.data_ptr(),
                dtype, int(relu), n, c, hw, nblk, _stream(x))
    if err != 0:
        raise RuntimeError(f"flax_bn_apply kernel failed: cudaError_t {err}")
    flax_bn_apply.launches += 1
    return out


flax_bn_apply.launches = 0


def batch_moments(x: torch.Tensor, stats_sum: Optional[Callable] = None):
    """(E[x], E[x^2], element count) per channel over (N, H, W), over the
    group `stats_sum` sums over when given (the count then a tensor).

    The sums are `flax_bn_reduce`'s.  Without a group the moments are the
    sums times 1 / count rounded to the compute dtype, as torch.mean
    scales its sum on the card."""
    c = x.shape[1]
    count = float(x.numel() // c)
    sums = flax_bn_reduce(x).to(compute_dtype(x.dtype))
    if stats_sum is None:
        return sums[0] * (1.0 / count), sums[1] * (1.0 / count), count
    tot = stats_sum(torch.cat([sums.reshape(-1), sums.new_full((1,), count)]))
    return tot[:c] / tot[-1], tot[c:2 * c] / tot[-1], tot[-1]


class FlaxBatchNormFn(torch.autograd.Function):
    """flax's BatchNorm (+ ReLU) with its closed-form backward (see the
    module docstring).  Train mode updates the running statistics in
    place."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, training,
                momentum, eps, stats_sum, relu):
        cdt = compute_dtype(x.dtype)
        keep = None
        if training:
            mean, sq, count = batch_moments(x, stats_sum)
            diff = sq - mean * mean
            var = torch.clamp(diff, min=0.0)
            keep = diff >= 0            # where torch.clamp passes gradients
            running_mean.mul_(1.0 - momentum).add_(momentum * mean)
            running_var.mul_(1.0 - momentum).add_(momentum * var)
            ctx.count = count
        else:
            mean, var = running_mean.to(cdt), running_var.to(cdt)
        r = torch.rsqrt(var + eps)
        coef = torch.stack([mean, r * weight.detach(), bias.detach()]).to(cdt)
        ctx.save_for_backward(x, coef, r, keep)
        ctx.training, ctx.stats_sum, ctx.relu = training, stats_sum, relu
        return flax_bn_apply(x, coef, relu)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, coef, r, keep = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dy = dy.contiguous()
        dx = dw = db = None
        if ctx.training or need_w or need_b:
            sums = flax_bn_reduce(x, dy, coef, ctx.relu).to(coef.dtype)
            db = sums[0] if need_b else None
            dw = sums[1] * r if need_w else None
        if need_x:
            if ctx.training:
                if ctx.stats_sum is not None:
                    sums = ctx.stats_sum(sums.reshape(-1)).reshape(2, -1)
                gmean = sums[0] / ctx.count
                k = torch.where(keep, r * r * sums[1] / ctx.count, 0.0)
            else:
                gmean = k = torch.zeros_like(r)
            dx = flax_bn_apply(x, torch.cat([coef, gmean[None], k[None]]),
                               ctx.relu, dy)
        return dx, dw, db, None, None, None, None, None, None, None


def flax_batch_norm(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, running_mean: torch.Tensor,
                    running_var: torch.Tensor, training: bool,
                    momentum: float, eps: float,
                    stats_sum: Optional[Callable] = None,
                    relu: bool = False) -> torch.Tensor:
    """flax's BatchNorm of NCHW x (then ReLU where `relu`), differentiable
    to x, weight and bias; train mode takes the batch's statistics (over
    the ranks that `stats_sum` sums over, when given) and moves the running
    ones by `momentum`, eval mode uses the running ones."""
    return FlaxBatchNormFn.apply(x, weight, bias, running_mean, running_var,
                                 training, momentum, eps, stats_sum, relu)

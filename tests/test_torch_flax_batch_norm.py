"""flax's BatchNorm (+ fused ReLU) of ops/cuda/flax_batch_norm.py: the closed
form and its kernels (csrc/flax_batch_norm.cu).

On the CPU the Function runs its plain twins; each case holds its output,
dx, dweight, dbias and running statistics to autograd through the formula
`models/norm.py::FlaxBatchNorm2d` ran before the closed form
(`formula_reference`, then nn.ReLU where fused): float64 to 1e-12, float32
and bfloat16 inputs to rounding; train and eval mode; with and without the
ReLU; a `stats_sum` over two shards run in two threads (each shard's
statistics and backward sums all-reduced through a barrier) against the
whole batch; a constant channel (the variance clamp); C = 1024 at H W = 12.
The wrappers' argument checks run on `meta` tensors, which take the kernels'
path up to the launch.

The `cuda` tests hold the kernels to the plain twins on the card at the
UNet's 18 norm shapes at B=14 (bf16) and at RAFT's context-encoder shapes
(f32), chip_smoke.py's phase 49 check: the elementwise passes bit for bit
from the same coefficients, the sums to f32 rounding, each launch's bits
the same in two calls; the whole Function on the card against the CPU; the
wrappers raising on what the kernels do not take:

    python -m pytest --noconftest -m cuda tests/test_torch_flax_batch_norm.py

No JAX here: the card tests run with `--noconftest` on the GPU machine.
"""

import threading

import pytest
import torch
from torch import nn

from card_cases import FLAX_BN_SHAPES, flax_bn_check, flax_bn_inputs
from motionpriorcmax_tpu_torch.models.norm import FlaxBatchNorm2d
from motionpriorcmax_tpu_torch.ops.cuda import flax_batch_norm as fbn

MOMENTUM, EPS = 0.1, 1e-5


def formula_reference(x, weight, bias, running_mean, running_var, training,
                      stats_sum=None):
    """FlaxBatchNorm2d.forward as it was before the closed form, for autograd
    to differentiate (float64 inputs computed in float64)."""
    xf = x.to(fbn.compute_dtype(x.dtype))
    if training:
        if stats_sum is None:
            mean = xf.mean(dim=(0, 2, 3))
            sq = (xf * xf).mean(dim=(0, 2, 3))
        else:
            c = xf.shape[1]
            sums = stats_sum(torch.cat([
                xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
                torch.full_like(xf[0, :1, 0, 0], xf.numel() // c)]))
            mean = sums[:c] / sums[-1]
            sq = sums[c:2 * c] / sums[-1]
        var = torch.clamp(sq - mean * mean, min=0.0)
        with torch.no_grad():
            running_mean.mul_(1.0 - MOMENTUM).add_(MOMENTUM * mean)
            running_var.mul_(1.0 - MOMENTUM).add_(MOMENTUM * var)
    else:
        mean, var = running_mean, running_var
    mul = torch.rsqrt(var + EPS) * weight
    y = (xf - mean[None, :, None, None]) * mul[None, :, None, None] \
        + bias[None, :, None, None]
    return y.to(x.dtype)


def make_inputs(dtype, shape, seed, constant_channel=False):
    """x, the output's cotangent, weight, bias, running mean and variance;
    parameters and statistics in float64 for float64 inputs, else float32."""
    g = torch.Generator().manual_seed(seed)
    n, c, h, w = shape
    pdt = fbn.compute_dtype(dtype)
    x = (torch.randn(shape, generator=g, dtype=torch.float64) * 1.7
         + torch.linspace(-2.0, 3.0, c, dtype=torch.float64)[:, None, None])
    if constant_channel:
        # In f32 over SHAPE, E[x^2] - E[x]^2 of 0.3 is -7.5e-9: clamped.
        x[:, c // 2] = 0.3
    cot = torch.randn(shape, generator=g, dtype=torch.float64)
    weight = 1.0 + 0.3 * torch.randn(c, generator=g, dtype=torch.float64)
    bias = 0.2 * torch.randn(c, generator=g, dtype=torch.float64)
    rm = 0.5 * torch.randn(c, generator=g, dtype=torch.float64)
    rv = 0.5 + torch.rand(c, generator=g, dtype=torch.float64)
    return (x.to(dtype), cot.to(dtype), weight.to(pdt), bias.to(pdt),
            rm.to(pdt), rv.to(pdt))


def run(fn, x, cot, weight, bias, rm, rv):
    """fn's output and the gradients of <output, cot> to x, weight, bias;
    the running statistics after the call."""
    x = x.clone().requires_grad_(True)
    weight = weight.clone().requires_grad_(True)
    bias = bias.clone().requires_grad_(True)
    rm, rv = rm.clone(), rv.clone()
    y = fn(x, weight, bias, rm, rv)
    (y.to(cot.dtype) * cot).sum().backward()
    return y.detach(), x.grad, weight.grad, bias.grad, rm, rv


class TwoShardSum:
    """A group sum over two shards that run in two threads: each member's
    tensor is exchanged through a barrier and both get slot 0 + slot 1."""

    def __init__(self):
        self.barrier = threading.Barrier(2, timeout=120)
        self.slots = [None, None]

    def member(self, i):
        def group_sum(t):
            self.slots[i] = t.detach().clone()
            self.barrier.wait()
            out = self.slots[0] + self.slots[1]
            self.barrier.wait()
            return out
        return group_sum


def run_two_shards(relu, x, cot, weight, bias, rm, rv):
    """The Function over two shards of the batch, in two threads, with the
    two-shard group sum: the shards' outputs and dx concatenated, their
    dweight and dbias added (what the mesh's gradient sum sees), each
    shard's running statistics."""
    group, half = TwoShardSum(), x.shape[0] // 2
    results, errors = [None, None], []

    def shard(i):
        try:
            sl = slice(0, half) if i == 0 else slice(half, None)
            results[i] = run(
                lambda *a: fbn.flax_batch_norm(
                    *a, True, MOMENTUM, EPS, group.member(i), relu),
                x[sl], cot[sl], weight, bias, rm, rv)
        except Exception as e:       # noqa: BLE001 - reraised below
            errors.append(e)
            group.barrier.abort()

    threads = [threading.Thread(target=shard, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors:
        raise errors[0]
    assert not any(t.is_alive() for t in threads)
    (y0, dx0, dw0, db0, rm0, rv0), (y1, dx1, dw1, db1, rm1, rv1) = results
    for a, b in ((rm0, rm1), (rv0, rv1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    return (torch.cat([y0, y1]), torch.cat([dx0, dx1]), dw0 + dw1, db0 + db1,
            rm0, rv0)


# Tolerances relative to max |reference| of each quantity: float64 the
# closed form's algebra alone (measured: 3e-16); float32 its rounding, the
# backward's terms in another association (measured: 4.7e-7); bfloat16
# outputs and dx at most one step of 8 bits apart where the f32 values
# straddle one (measured: 1.1e-3).  Card against CPU, the sums in another
# order besides: a bf16 value next to the largest one step apart, f32 a few
# roundings of the statistics.
TOL = {torch.float64: 1e-12, torch.float32: 2e-6, torch.bfloat16: 2 ** -8}
TOL_CARD = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
NAMES = ("y", "dx", "dweight", "dbias", "running_mean", "running_var")
SHAPE = (4, 6, 5, 7)


def cases():
    out = []
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for training in (True, False):
            for relu in (False, True):
                out.append(pytest.param(
                    dtype, training, relu, "none", SHAPE,
                    id=f"{name}-{'train' if training else 'eval'}-"
                       f"{'relu' if relu else 'norelu'}"))
        for relu in (False, True):
            out.append(pytest.param(
                dtype, True, relu, "two_shards", SHAPE,
                id=f"{name}-train-{'relu' if relu else 'norelu'}-two_shards"))
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[1]
        out.append(pytest.param(dtype, True, True, "constant_channel", SHAPE,
                                id=f"{name}-train-relu-constant_channel"))
    out.append(pytest.param(torch.bfloat16, True, True, "none", (2, 1024, 3, 4),
                            id="bfloat16-train-relu-C1024_HW12"))
    out.append(pytest.param(torch.float32, False, False, "none",
                            (2, 1024, 3, 4), id="float32-eval-C1024_HW12"))
    return out


@pytest.mark.parametrize("dtype,training,relu,variant,shape", cases())
def test_closed_form_matches_autograd_of_the_formula(dtype, training, relu,
                                                     variant, shape):
    inputs = make_inputs(dtype, shape, seed=sum(shape) + len(variant),
                         constant_channel=variant == "constant_channel")

    def reference(x, weight, bias, rm, rv):
        y = formula_reference(x, weight, bias, rm, rv, training)
        return nn.ReLU()(y) if relu else y

    want = run(reference, *inputs)
    if variant == "two_shards":
        got = run_two_shards(relu, *inputs)
    else:
        got = run(lambda *a: fbn.flax_batch_norm(
            *a, training, MOMENTUM, EPS, None, relu), *inputs)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        g, w = g.double(), w.double()
        scale = max(float(w.abs().max()), 1e-30)
        err = float((g - w).abs().max()) / scale
        assert err <= TOL[dtype], f"{name}: {err:.3g} of {scale:.3g}"
    if relu:
        assert float(got[0].min()) >= 0


def test_module_fuses_relu_and_counts_batches():
    """FlaxBatchNorm2d(relu=True) is the norm then nn.ReLU; train mode counts
    the batch, eval mode does not, and the state-dict keys are
    nn.BatchNorm2d's."""
    torch.manual_seed(0)
    x = torch.randn(3, 4, 5, 6)
    fused, plain = FlaxBatchNorm2d(4, relu=True), FlaxBatchNorm2d(4)
    with torch.no_grad():
        for m in (fused, plain):
            m.weight.copy_(torch.linspace(0.5, 1.5, 4))
            m.bias.copy_(torch.linspace(-0.3, 0.3, 4))
    torch.testing.assert_close(fused(x), torch.relu(plain(x)), rtol=0, atol=0)
    assert int(fused.num_batches_tracked) == 1
    fused.eval()
    fused(x)
    assert int(fused.num_batches_tracked) == 1
    assert set(fused.state_dict()) == set(nn.BatchNorm2d(4).state_dict())


@pytest.mark.parametrize("case", ["dtype", "noncontiguous", "dy_noncontiguous",
                                  "dims", "coef_shape", "dy_dtype", "cpu_meta"])
def test_argument_checks_raise(case):
    meta = {"device": "meta"}
    x = torch.empty(2, 3, 4, 8, **meta)
    coef3 = torch.empty(3, 3, **meta)
    coef5 = torch.empty(5, 3, **meta)
    call, err = {
        "dtype": (lambda: fbn.flax_bn_apply(x.half(), coef3, True), TypeError),
        "noncontiguous": (lambda: fbn.flax_bn_reduce(
            torch.empty(2, 3, 8, 4, **meta).transpose(2, 3)), ValueError),
        "dy_noncontiguous": (lambda: fbn.flax_bn_apply(
            x, coef5, True, torch.empty(2, 3, 8, 4, **meta).transpose(2, 3)),
            ValueError),
        "dims": (lambda: fbn.flax_bn_reduce(torch.empty(2, 3, 4, **meta)),
                 ValueError),
        "coef_shape": (lambda: fbn.flax_bn_apply(x, coef5, False), ValueError),
        "dy_dtype": (lambda: fbn.flax_bn_reduce(x, x.bfloat16(), coef3),
                     ValueError),
        "cpu_meta": (lambda: fbn.flax_bn_apply(x, coef3, False), ValueError),
    }[case]
    before = fbn.flax_bn_reduce.launches, fbn.flax_bn_apply.launches
    with pytest.raises(err):
        call()
    assert (fbn.flax_bn_reduce.launches, fbn.flax_bn_apply.launches) == before


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# chip_smoke.py's phase 49 shapes (each of the UNet's norm shapes at B=14,
# bf16, and of RAFT-Spline's context encoder at B=6, f32), and one whose
# H W is no multiple of a 16-byte vector (the kernels' scalar loads).
CARD_CASES = ([pytest.param(b, c, hw, dname, id=label)
               for label, b, c, hw, dname, _, _ in FLAX_BN_SHAPES]
              + [pytest.param(3, 5, (7, 9), name, id=f"odd-{name}")
                 for name in ("bfloat16", "float32")])


def card_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,hw,dname", CARD_CASES)
def test_kernels_match_plain_on_card(b, c, hw, dname):
    """Each launch against its plain twin on the same card inputs, with and
    without the ReLU (card_cases.flax_bn_check): y and dx bit for bit, the
    sums to 1e-5 of the sums of |terms|; every launch's bits the same in a
    second call."""
    card_or_skip()
    x, dy, coef3, coef5 = flax_bn_inputs(torch, b, c, hw,
                                         getattr(torch, dname), seed=c)
    for relu in (False, True):
        flax_bn_check(torch, x, dy, coef3, coef5, relu)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("training", [True, False])
def test_function_on_card_matches_cpu(dtype, training):
    """The whole norm (+ ReLU), forward and backward, on the card (kernels)
    against the CPU (plain twins) on the same inputs: to rounding, as the
    CPU tests hold the twins to the formula."""
    card_or_skip()
    inputs = make_inputs(dtype, (6, 64, 24, 32), seed=5)
    fn = lambda *a: fbn.flax_batch_norm(*a, training, MOMENTUM, EPS, None,
                                         True)
    want = run(fn, *inputs)
    before = fbn.flax_bn_reduce.launches, fbn.flax_bn_apply.launches
    got = run(fn, *(t.cuda() for t in inputs))
    torch.cuda.synchronize()
    assert (fbn.flax_bn_reduce.launches - before[0],
            fbn.flax_bn_apply.launches - before[1]) == (
                (4, 2) if training else (2, 2))
    for name, g, w in zip(NAMES, got, want):
        g, w = g.cpu().double(), w.double()
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        assert err <= TOL_CARD[dtype], f"{name}: {err:.3g}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dtype", "noncontiguous", "dy_noncontiguous"])
def test_wrappers_raise_on_card(case):
    card_or_skip()
    x = torch.zeros(2, 3, 4, 8, device="cuda")
    coef3 = torch.zeros(3, 3, device="cuda")
    coef5 = torch.zeros(5, 3, device="cuda")
    call, err = {
        "dtype": (lambda: fbn.flax_bn_reduce(x.half()), TypeError),
        "noncontiguous": (lambda: fbn.flax_bn_apply(
            x.transpose(2, 3), coef3, True), ValueError),
        "dy_noncontiguous": (lambda: fbn.flax_bn_reduce(
            x, x.transpose(2, 3).contiguous().transpose(2, 3), coef3, True),
            ValueError),
    }[case]
    before = fbn.flax_bn_reduce.launches, fbn.flax_bn_apply.launches
    with pytest.raises(err):
        call()
    assert (fbn.flax_bn_reduce.launches, fbn.flax_bn_apply.launches) == before

"""Port's any-order segment sum (kernel row 5, the backward of the LUT
gather on unsorted events) vs the JAX package.

The oracles: JAX `grid_gather(bwd_impl='native')`, whose backward is an
exact f32 scatter, and the Pallas `segment_sum_pallas` in interpret mode,
which votes through bf16 tap tiles.  On the CPU the port's wrapper runs its
plain version; the CUDA kernel is held against it by the `cuda` test, on
the card:

    python -m pytest --noconftest -m cuda tests/test_torch_segment_sum.py
"""

import numpy as np
import pytest
import torch

from motionpriorcmax_tpu_torch.ops import events as tev
from motionpriorcmax_tpu_torch.ops.cuda import segment_sum as ss

try:
    import jax
    import jax.numpy as jnp

    from motionpriorcmax_tpu.ops import events as jev
    from motionpriorcmax_tpu.ops.pallas.iwe_vote import segment_sum_pallas
except ImportError:         # the GPU machine: only the cuda test runs there
    jax = None


def make_inputs(seed, b=2, r=45, x=16, c=2, m=5003, pad=0.1):
    """A grid, events in random order over its cells (skewed, many cells
    empty), a tail of padding rows in cell (0, 0) with zero cotangent, as
    the collate pads, and normal cotangents."""
    rng = np.random.default_rng(seed)
    grid = rng.normal(size=(b, r, x, c)).astype(np.float32)
    flat = np.minimum(rng.exponential(r * x / 3, (b, m)), r * x - 1
                      ).astype(np.int64)
    g = rng.normal(size=(b, m, c)).astype(np.float32)
    n_pad = int(m * pad)
    if n_pad:
        flat[:, m - n_pad:] = 0
        g[:, m - n_pad:] = 0.0
    return (grid, (flat // x).astype(np.int32), (flat % x).astype(np.int32),
            g)


def port_segsum(rows, cols, g, r, x):
    return ss.segment_sum_plain(torch.from_numpy(rows), torch.from_numpy(cols),
                                torch.from_numpy(g), r, x).numpy()


def jax_native_grad(grid, rows, cols, g):
    """d grid of sum(grid_gather(...) * g) with the 'native' backward."""
    def f(gr):
        out = jev.grid_gather(gr, jnp.asarray(rows), jnp.asarray(cols),
                              "native")
        return jnp.sum(out * jnp.asarray(g))
    return np.asarray(jax.grad(f)(jnp.asarray(grid)))


@pytest.mark.parametrize("c,pad", [(2, 0.1), (4, 0.0), (1, 0.3)])
def test_plain_matches_jax_native_scatter(c, pad):
    # Both are f32 scatters; they add a cell's events in another order:
    # within 1e-5 of the largest |value|.
    grid, rows, cols, g = make_inputs(c, c=c, pad=pad)
    b, r, x, _ = grid.shape
    got = port_segsum(rows, cols, g, r, x)
    want = jax_native_grad(grid, rows, cols, g)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_plain_matches_pallas_segment_sum_interpret():
    # The Pallas kernel rounds its tap tiles to bf16: JAX's own bound,
    # 2e-2 of the largest |value| (tests/test_pallas_iwe.py).
    grid, rows, cols, g = make_inputs(7, b=2, r=16, x=12, m=900)
    b, r, x, _ = grid.shape
    got = port_segsum(rows, cols, g, r, x)
    want = np.asarray(segment_sum_pallas(jnp.asarray(rows), jnp.asarray(cols),
                                         jnp.asarray(g), r, x, True))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


def test_plain_matches_f64_oracle_and_clamps():
    # Each cell's f32 sum against the f64 sum; out-of-range indices land
    # on the clamped edge cells, as the kernel puts them.
    grid, rows, cols, g = make_inputs(3, pad=0.0)
    b, r, x, c = grid.shape
    rows[0, :5] = [-4, r, r + 9, 0, -1]
    cols[0, :5] = [x + 2, -3, 0, x, 2]
    want = np.zeros((b, r * x, c), np.float64)
    for i in range(b):
        np.add.at(want[i], np.clip(rows[i], 0, r - 1).astype(np.int64) * x
                  + np.clip(cols[i], 0, x - 1), g[i])
    got = port_segsum(rows, cols, g, r, x).reshape(b, r * x, c)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_gather_any_order_gradient_matches_autograd_of_plain_gather():
    # Forward: a selection, bit for bit; gradient: the segment sum equals
    # autograd's scatter-add through torch.gather up to summation order.
    grid, rows, cols, g = make_inputs(11, c=2)
    b, r, x, c = grid.shape
    gr = torch.from_numpy(grid).requires_grad_()
    rt, ct, gt = (torch.from_numpy(a) for a in (rows, cols, g))
    before = ss.grid_segment_sum.launches
    out = tev.grid_gather(gr, rt, ct)
    (out * gt).sum().backward()
    assert ss.grid_segment_sum.launches == before     # CPU: plain version

    ref = torch.from_numpy(grid).requires_grad_()
    flat = rt.long() * x + ct.long()
    ref_out = torch.gather(ref.reshape(b, r * x, c), 1,
                           flat[..., None].expand(-1, -1, c))
    (ref_out * gt).sum().backward()
    assert torch.equal(out, ref_out)
    torch.testing.assert_close(gr.grad, ref.grad, rtol=0,
                               atol=1e-6 * float(ref.grad.abs().max()))


def test_wrapper_checks_its_inputs():
    grid, rows, cols, g = make_inputs(1)
    rt, ct, gt = (torch.from_numpy(a) for a in (rows, cols, g))
    with pytest.raises(TypeError):
        ss.grid_segment_sum(rt.long(), ct, gt, 45, 16)
    with pytest.raises(ValueError):
        ss.grid_segment_sum(rt, ct, gt[:, :-1], 45, 16)
    with pytest.raises(TypeError):
        ss.grid_segment_sum(rt, ct, gt.double(), 45, 16)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Kernel vs plain on the card, both f32 scatters that add a cell's
    events in a run-dependent order: within 1e-5 of the largest |value|.
    Padding rows (zero cotangent) make no atomics and change nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for c, pad in ((2, 0.1), (1, 0.0), (6, 0.3)):
        grid, rows, cols, g = make_inputs(20 + c, b=3, r=90, x=40, c=c,
                                          m=70001, pad=pad)
        b, r, x, _ = grid.shape
        rt, ct, gt = (torch.from_numpy(a).cuda() for a in (rows, cols, g))
        before = ss.grid_segment_sum.launches
        got = ss.grid_segment_sum(rt, ct, gt, r, x)
        torch.cuda.synchronize()
        assert ss.grid_segment_sum.launches == before + 1
        want = ss.segment_sum_plain(rt, ct, gt, r, x)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
        # Through the autograd Function: one launch in the backward.
        gr = torch.from_numpy(grid).cuda().requires_grad_()
        (tev.grid_gather(gr, rt, ct) * gt).sum().backward()
        assert ss.grid_segment_sum.launches == before + 2
        torch.testing.assert_close(gr.grad, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("c,m,pad", [(4, 70001, 0.1), (6, 70003, 0.0),
                                     (8, 70002, 0.3), (2, 70001, 0.5)])
def test_kernel_vector_reductions_on_card(c, m, pad):
    """Each event's C cotangents go out as float2 / float4 reductions
    (C = 6: three float2s) and 4 events per thread are loaded 16 bytes at
    a time: every C, a ragged tail (M not a multiple of 4) and padding
    that starts mid-group, against the plain version (as above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    grid, rows, cols, g = make_inputs(40 + c, b=3, r=90, x=40, c=c, m=m,
                                      pad=pad)
    rows[1, m // 2:m // 2 + 3] = 0           # three events on row 0,
    g[1, m // 2 + 1] = 0.0                   # one of them dead: a mixed group
    rt, ct, gt = (torch.from_numpy(a).cuda() for a in (rows, cols, g))
    got = ss.grid_segment_sum(rt, ct, gt, 90, 40)
    want = ss.segment_sum_plain(rt, ct, gt, 90, 40)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
def test_kernel_hot_cell_on_card():
    """Half the events of each sample on one cell (same-address
    reductions), the rest spread; the hot cell's sum of ~35k terms differs
    from the plain version's by its summation order alone: 1e-4 of the
    largest |value| (card_cases.TOL_SEGMENT_SUM_FEW)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    grid, rows, cols, g = make_inputs(50, b=3, r=90, x=40, c=2, m=70001,
                                      pad=0.05)
    rng = np.random.default_rng(51)
    hot = rng.random(rows.shape) < 0.5
    rows[hot], cols[hot] = 17, 23
    rt, ct, gt = (torch.from_numpy(a).cuda() for a in (rows, cols, g))
    got = ss.grid_segment_sum(rt, ct, gt, 90, 40)
    want = ss.segment_sum_plain(rt, ct, gt, 90, 40)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))

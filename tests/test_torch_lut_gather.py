"""Port's flow-LUT gather and sorted segment sum (kernel row 6) vs the JAX
package.

The oracles: the JAX 'xla' gather (ops/events.py::_gather_rows) and the
'sorted' cumsum backward of grid_gather, an f64 numpy segment sum, and the
Pallas `lut_gather_sorted` in interpret mode (also as the boundary gather of
the 'sorted_pallas' backward).  On the CPU the port's wrappers run their
plain versions; the CUDA kernels are held against those by the `cuda`
test, on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_lut_gather.py
"""

import numpy as np
import pytest
import torch

from motionpriorcmax_tpu_torch.ops.cuda import lut_gather as lg

try:
    import jax
    import jax.numpy as jnp

    from motionpriorcmax_tpu.ops import events as jev
    from motionpriorcmax_tpu.ops.pallas.lut_gather import lut_gather_sorted
except ImportError:         # the GPU machine: only the cuda test runs there
    jax = None


def make_sorted(seed, b=2, r=45, x=16, c=2, m=5003, segs=2):
    """A LUT, cell-sorted events in `segs` segments and their cell_ends,
    the layout of data/host_ops.py::lut_cell_sort."""
    rng = np.random.default_rng(seed)
    lut = rng.normal(size=(b, r, x, c)).astype(np.float32)
    cells = r * x
    bounds = np.linspace(0, m, segs + 1).astype(int)
    flat = np.empty((b, m), np.int64)
    ends = np.empty((b, segs * cells), np.int64)
    for i in range(b):
        for s in range(segs):
            lo, hi = bounds[s], bounds[s + 1]
            # Skewed: many empty cells, some dense ones.
            keys = np.sort(np.minimum(rng.exponential(cells / 3, hi - lo),
                                      cells - 1).astype(np.int64))
            flat[i, lo:hi] = keys
            ends[i, s * cells:(s + 1) * cells] = lo + np.searchsorted(
                keys, np.arange(cells), side="right")
    rows = (flat // x).astype(np.int32)
    cols = (flat % x).astype(np.int32)
    g = rng.normal(size=(b, m, c)).astype(np.float32)
    return lut, rows, cols, ends.astype(np.int32), g


def oracle_segsum(g, rows, cols, r, x):
    out = np.zeros((g.shape[0], r * x, g.shape[2]), np.float64)
    for i in range(g.shape[0]):
        np.add.at(out[i], rows[i].astype(np.int64) * x + cols[i], g[i])
    return out


def test_gather_plain_equals_jax():
    # A selection: bit-exact against the 'xla' gather and the Pallas
    # kernel (interpret mode, f32 one-hot contraction: one non-zero term).
    lut, rows, cols, _, _ = make_sorted(0)
    got = lg.lut_gather_plain(torch.from_numpy(lut), torch.from_numpy(rows),
                              torch.from_numpy(cols)).numpy()
    want = np.asarray(jev._gather_rows(jnp.asarray(lut), jnp.asarray(rows),
                                       jnp.asarray(cols)))
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(lut_gather_sorted(jnp.asarray(lut), jnp.asarray(rows),
                                          jnp.asarray(cols), interpret=True,
                                          band_rows=32))
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("segs", [1, 2])
def test_segsum_plain_matches_f64_oracle(segs):
    # Each cell's sum rounds to f32 once: within half an ulp of the f64
    # sum (rtol 1e-7), atol 1e-6 for the cancelling sums of N(0, 1) values.
    lut, rows, cols, ends, g = make_sorted(1, segs=segs)
    b, r, x, c = lut.shape
    got = lg.lut_segsum_plain(torch.from_numpy(g), torch.from_numpy(ends),
                              r * x).numpy()
    np.testing.assert_allclose(got, oracle_segsum(g, rows, cols, r, x),
                               rtol=1e-7, atol=1e-6)


@pytest.mark.parametrize("impl", ["sorted", "sorted_pallas"])
@pytest.mark.parametrize("segs", [1, 2])
def test_segsum_plain_matches_jax_backward(impl, segs):
    # JAX's backward differences a running f32 sum over all M events, so it
    # carries ~sqrt(M) * eps * |csum| of rounding (2.8e-4 at 1M events,
    # ops/events.py:391-395); here M = 5003: atol 1e-4.
    lut, rows, cols, ends, g = make_sorted(2, segs=segs)
    b, r, x, c = lut.shape

    def loss(t):
        out = jev.grid_gather(t, jnp.asarray(rows), jnp.asarray(cols), impl,
                              jnp.asarray(ends))
        return jnp.sum(out * g)

    want = np.asarray(jax.grad(loss)(jnp.asarray(lut)))
    got = lg.lut_segsum_plain(torch.from_numpy(g), torch.from_numpy(ends),
                              r * x).numpy().reshape(b, r, x, c)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_autograd_function_pairs_gather_and_segsum():
    lut, rows, cols, ends, g = make_sorted(3, m=2000)
    b, r, x, c = lut.shape
    t = torch.from_numpy(lut).requires_grad_()
    out = lg.lut_gather(t, torch.from_numpy(rows), torch.from_numpy(cols),
                        torch.from_numpy(ends))
    (out * torch.from_numpy(g)).sum().backward()
    want = lg.lut_segsum_plain(torch.from_numpy(g), torch.from_numpy(ends),
                               r * x).reshape(b, r, x, c)
    assert torch.equal(t.grad, want)


def test_wrappers_reject_bad_inputs():
    lut, rows, cols, ends, g = make_sorted(4, m=100)
    with pytest.raises(TypeError):
        lg.lut_gather_fwd(torch.from_numpy(lut), torch.from_numpy(rows).long(),
                          torch.from_numpy(cols))
    with pytest.raises(ValueError):
        lg.lut_segsum_bwd(torch.from_numpy(g), torch.from_numpy(ends)[:, :-1],
                          lut.shape[1] * lut.shape[2])


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Gather: exact (a selection).  Segment sum against the plain version
    (f64 running sum, one f32 rounding per cell): the kernel adds a cell's
    events one by one in f32, so a cell of n events carries up to ~n ulps;
    the clipped last cell holds thousands: rtol 1e-4 + atol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for segs in (1, 2):
        lut, rows, cols, ends, g = make_sorted(5, b=3, r=90, x=40, m=70001,
                                               segs=segs)
        b, r, x, c = lut.shape
        lt, rt, ct, et, gt = (torch.from_numpy(a).cuda()
                              for a in (lut, rows, cols, ends, g))
        before = (lg.lut_gather_fwd.launches, lg.lut_segsum_bwd.launches)
        out = lg.lut_gather_fwd(lt, rt, ct)
        dl = lg.lut_segsum_bwd(gt, et, r * x)
        torch.cuda.synchronize()
        assert (lg.lut_gather_fwd.launches, lg.lut_segsum_bwd.launches) == (
            before[0] + 1, before[1] + 1)
        assert torch.equal(out, lg.lut_gather_plain(lt, rt, ct))
        torch.testing.assert_close(dl, lg.lut_segsum_plain(gt, et, r * x),
                                   rtol=1e-4, atol=1e-5)

"""Port's flow-LUT gather and sorted segment sum (kernel row 6) vs the JAX
package.

The oracles: the JAX 'xla' gather (ops/events.py::_gather_rows) and the
'sorted' cumsum backward of grid_gather, an f64 numpy segment sum, and the
Pallas `lut_gather_sorted` in interpret mode (also as the boundary gather of
the 'sorted_pallas' backward).  On the CPU the port's wrappers run their
plain versions, and `lut_segsum_tiled_plain` (the segment-sum kernel's
partition into tiles and pieces) is held against them at small tile and
piece sizes; the CUDA kernels are held against the plain versions by the
`cuda` tests, on the card:

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


def layout_case(kind, segs, c, piece, tile, seed, b=2):
    """A LUT of 9 x 2 * tile cells and cell-sorted events in the loader's
    layout (make_sorted's) that stress the segment-sum kernel's partition
    at the given piece and tile sizes:
      padding     a run of cell 0 over five pieces at the start of every
                  segment (the padding rows), the rest spread over cells
      boundary    in segment 0 a run that ends exactly on a piece boundary
                  and the next one starting there, a piece long
      empty_tile  two and a half tiles of empty cells between dense ones,
                  and a run of two pieces
      one_cell    every event of a segment in one cell"""
    rng = np.random.default_rng(seed)
    r, x = 9, 2 * tile
    cells = r * x

    def spread(n, lo=0, hi=cells):
        return rng.integers(lo, hi, n)

    seg_keys = []
    for s in range(segs):
        if kind == "padding":
            keys = np.concatenate([spread(3 * piece // 2),
                                   np.zeros(5 * piece + 7, np.int64)])
        elif kind == "boundary" and s == 0:
            head = np.sort(spread(piece - 10, 0, 5))
            keys = np.concatenate([head, np.full(piece + 10, 5),
                                   np.full(piece, 6), spread(piece, 7)])
        elif kind == "empty_tile":
            keys = np.concatenate([spread(piece, 0, tile // 2),
                                   spread(piece, 3 * tile),
                                   np.full(2 * piece + 3, 4 * tile + 1)])
        elif kind == "one_cell":
            keys = np.full(5 * piece // 2 + 11, 7 + s)
        else:
            keys = spread(2 * piece + 5)
        seg_keys.append(np.sort(keys, kind="stable"))
    m = sum(len(k) for k in seg_keys)
    flat = np.concatenate(seg_keys)[None].repeat(b, 0)
    ends = np.empty((b, segs * cells), np.int64)
    lo = 0
    for s, keys in enumerate(seg_keys):
        ends[:, s * cells:(s + 1) * cells] = lo + np.searchsorted(
            keys, np.arange(cells), side="right")
        lo += len(keys)
    lut = rng.normal(size=(b, r, x, c)).astype(np.float32)
    g = rng.normal(size=(b, m, c)).astype(np.float32)
    return (lut, (flat // x).astype(np.int32), (flat % x).astype(np.int32),
            ends.astype(np.int32), g)


# (kind, S, C): the partition's edge cases, every segment count and the
# channel counts of 1, 3 and 4 reference times and one.
LAYOUT_CASES = [("padding", 2, 2), ("padding", 1, 1), ("boundary", 2, 6),
                ("boundary", 1, 8), ("empty_tile", 2, 8), ("empty_tile", 1, 1),
                ("one_cell", 2, 2), ("one_cell", 1, 6)]


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


@pytest.mark.parametrize("kind,segs,c", LAYOUT_CASES)
def test_segsum_tiled_partition_matches_plain_oracle_and_jax(kind, segs, c):
    # The kernel's partition at tiles of 8 cells, pieces of 64 events and
    # windows of 20: every event is added exactly once (up to the last
    # end); its sums are f32 partials (each rounded once) added in f32, so
    # against the plain version and the f64 oracle a cell may carry a few
    # ulps of its largest partial: atol 2e-6 x max(1, max |sum|).  JAX's
    # backward differences a running f32 sum: atol 1e-4, as above.
    lut, rows, cols, ends, g = layout_case(kind, segs, c, 64, 8, 10 + c)
    b, r, x, _ = lut.shape
    gt, et = torch.from_numpy(g), torch.from_numpy(ends)
    got, cover = lg.lut_segsum_tiled_plain(gt, et, r * x, tile=8, piece=64,
                                           window=20)
    assert torch.equal(cover, torch.ones_like(cover))
    want = lg.lut_segsum_plain(gt, et, r * x).numpy()
    atol = 2e-6 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    oracle = oracle_segsum(g, rows, cols, r, x)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=0, atol=atol)

    def loss(t):
        out = jev.grid_gather(t, jnp.asarray(rows), jnp.asarray(cols),
                              "sorted", jnp.asarray(ends))
        return jnp.sum(out * g)

    jax_grad = np.asarray(jax.grad(loss)(jnp.asarray(lut)))
    np.testing.assert_allclose(got.numpy().reshape(b, r, x, c), jax_grad,
                               rtol=0, atol=1e-4)


def test_segsum_tiled_coverage_stops_at_the_last_end():
    # Events after the last end belong to no cell: counted zero times.
    lut, rows, cols, ends, g = layout_case("padding", 2, 2, 64, 8, 3)
    m = g.shape[1]
    ends = np.minimum(ends, m - 30)      # the last 30 events fall outside
    got, cover = lg.lut_segsum_tiled_plain(
        torch.from_numpy(g), torch.from_numpy(ends), lut.shape[1] *
        lut.shape[2], tile=8, piece=64, window=20)
    assert torch.equal(cover[:, :m - 30], torch.ones(2, m - 30,
                                                     dtype=torch.int64))
    assert not cover[:, m - 30:].any()
    want = lg.lut_segsum_plain(torch.from_numpy(g), torch.from_numpy(ends),
                               lut.shape[1] * lut.shape[2])
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


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


@pytest.mark.cuda
@pytest.mark.parametrize("kind,segs", [("padding", 2), ("padding", 1),
                                       ("boundary", 2), ("empty_tile", 2),
                                       ("one_cell", 2), ("one_cell", 1)])
@pytest.mark.parametrize("c", lg.SEGSUM_CHANNELS)
def test_segsum_kernel_partition_cases_on_card(kind, segs, c):
    """The segment-sum kernel on the partition's edge cases at its own
    tile and piece sizes, against the plain version (tolerance as above),
    with identical bits in two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lut, rows, cols, ends, g = layout_case(kind, segs, c, lg.PIECE_EVENTS,
                                           lg.TILE_CELLS, 20 + c)
    cells = lut.shape[1] * lut.shape[2]
    gt, et = torch.from_numpy(g).cuda(), torch.from_numpy(ends).cuda()
    got = lg.lut_segsum_bwd(gt, et, cells)
    again = lg.lut_segsum_bwd(gt, et, cells)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    torch.testing.assert_close(got, lg.lut_segsum_plain(gt, et, cells),
                               rtol=1e-4, atol=1e-5)

"""Port's bilinear IWE vote (kernel rows 3 and 4) vs the JAX package.

The oracle is the JAX exact-f32 'direct' vote (ops/events.py::
iwe_bilinear_vote) and its autodiff; the Pallas kernels
(`iwe_vote_pallas_sorted`, `iwe_vote_pallas`) run in interpret mode with
their bf16 tap tiles.  JAX runs on the CPU (tests/conftest.py); inputs are
numpy arrays from a seed.  On the CPU the port's wrappers run their plain
versions; the CUDA kernels are held against those by the `cuda` test, on
the card:

    python -m pytest --noconftest -m cuda tests/test_torch_iwe_vote.py
"""

import numpy as np
import pytest
import torch

from motionpriorcmax_tpu_torch.ops.cuda import iwe_vote as iv

try:
    import jax
    import jax.numpy as jnp

    from motionpriorcmax_tpu.ops.events import iwe_bilinear_vote
    from motionpriorcmax_tpu.ops.pallas.iwe_vote import (
        BE, KB, iwe_vote_pallas, iwe_vote_pallas_sorted)
except ImportError:         # the GPU machine: only the cuda test runs there
    jax = None

H, W = 40, 56


def make_inputs(seed, b=2, m=3001, sort=False, far=True):
    """Warped-event-like coords (some off the image, some at +-1e9) and
    weights with zero-weight padding rows."""
    rng = np.random.default_rng(seed)
    y = rng.uniform(-4, H + 3, (b, m))
    if sort:
        y = np.sort(y, axis=1)
    x = rng.uniform(-4, W + 3, (b, m))
    coords = np.stack([y, x], -1).astype(np.float32)
    # Exact integers and values just under one: the +1e-6 floor nudge.
    coords[:, :50] = np.round(coords[:, :50])
    coords[:, 50:60] = np.floor(coords[:, 50:60]) - 5e-7
    if far:
        coords[:, 60:70, 0] = 1e9
        coords[:, 70:80, 1] = -1e9
        coords[:, 80:85] = -1e9
    wgt = rng.uniform(0.2, 2.0, (b, m)).astype(np.float32)
    wgt[:, -40:] = 0.0
    return coords, wgt


def jax_direct(coords, wgt, h=H, w=W):
    return jax.vmap(lambda c, v: iwe_bilinear_vote(
        c, v, height=h, width=w, scatter_impl="direct"))(coords, wgt)


@pytest.mark.parametrize("seed", [0, 1])
def test_vote_fwd_plain_matches_jax_direct(seed):
    # atol 1e-5: the same f32 corner weights; only the order in which the
    # votes of one pixel are added differs (index_add_ vs XLA's scatter),
    # and a pixel holds < 10 votes of magnitude < 2.
    coords, wgt = make_inputs(seed)
    want = np.asarray(jax_direct(jnp.asarray(coords), jnp.asarray(wgt)))
    got = iv.iwe_vote_fwd_plain(torch.from_numpy(coords),
                                torch.from_numpy(wgt), H, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_vote_bwd_plain_matches_jax_autodiff(seed):
    # The backward is the derivative of the 'direct' vote: d coords and
    # d weight of sum(vote * G) for a random image cotangent G.  atol 1e-5:
    # four f32 products summed in another order (|G| < 3, |w| < 2).
    coords, wgt = make_inputs(seed)
    g = np.random.default_rng(10 + seed).normal(size=(2, H, W)).astype(
        np.float32)

    def loss(c, v):
        return jnp.sum(jax_direct(c, v) * g)

    dc_j, dw_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(coords),
                                                jnp.asarray(wgt))
    dc, dw = iv.iwe_vote_bwd_plain(torch.from_numpy(coords),
                                   torch.from_numpy(wgt), torch.from_numpy(g),
                                   H, W)
    np.testing.assert_allclose(dc.numpy(), np.asarray(dc_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), rtol=0, atol=1e-5)
    # Far-out events: no vote, no gradient.
    assert not dc[:, 60:85].any()


def test_autograd_function_uses_bwd():
    # The autograd Function pairs the two launches: its gradients are
    # exactly the backward's outputs, with and without a weight gradient.
    coords, wgt = make_inputs(2, m=517)
    g = np.random.default_rng(3).normal(size=(2, H, W)).astype(np.float32)
    c = torch.from_numpy(coords).requires_grad_()
    v = torch.from_numpy(wgt).requires_grad_()
    (iv.iwe_vote(c, v, H, W) * torch.from_numpy(g)).sum().backward()
    dc, dw = iv.iwe_vote_bwd_plain(torch.from_numpy(coords),
                                   torch.from_numpy(wgt), torch.from_numpy(g),
                                   H, W)
    assert torch.equal(c.grad, dc) and torch.equal(v.grad, dw)
    c2 = torch.from_numpy(coords).requires_grad_()
    (iv.iwe_vote(c2, torch.from_numpy(wgt), H, W)
     * torch.from_numpy(g)).sum().backward()
    assert torch.equal(c2.grad, dc)


def test_vote_accepts_a_polarity_half():
    # make_iwes votes coords[:, :npos] of a larger array: a batch stride
    # other than M, the layout the kernel reads without a copy.
    coords, wgt = make_inputs(4, m=900)
    c, v = torch.from_numpy(coords), torch.from_numpy(wgt)
    half = iv.iwe_vote(c[:, 400:], v[:, 400:], H, W)
    full = iv.iwe_vote(c[:, 400:].contiguous(), v[:, 400:].contiguous(), H, W)
    assert torch.equal(half, full)


@pytest.mark.parametrize("sort", [True, False])
def test_vote_plain_matches_pallas_interpret(sort):
    # Row 3 (sorted events, banded kernel) and row 4 (any order, full-height
    # kernel) in interpret mode with the TPU's bf16 tap tiles: the tap
    # weights round to 8 mantissa bits, so the tolerance is 1e-2 of the
    # largest value (forward) and of the largest gradient (backward).
    # M spans more than one KB * BE program and is not a multiple of it.
    coords, wgt = make_inputs(5, b=2, m=KB * BE + 377, sort=sort, far=False)
    g = np.random.default_rng(6).normal(size=(2, H, W)).astype(np.float32)
    if sort:
        def vote(c, v):
            return iwe_vote_pallas_sorted(c, v, H, W, 32, jnp.bfloat16, True)
    else:
        def vote(c, v):
            return iwe_vote_pallas(c, v, H, W, jnp.bfloat16, True)
    cj, vj = jnp.asarray(coords), jnp.asarray(wgt)
    want = np.asarray(vote(cj, vj))
    dc_j, dw_j = jax.grad(lambda c, v: jnp.sum(vote(c, v) * g),
                          argnums=(0, 1))(cj, vj)
    ct, vt = torch.from_numpy(coords), torch.from_numpy(wgt)
    got = iv.iwe_vote_fwd_plain(ct, vt, H, W).numpy()
    dc, dw = iv.iwe_vote_bwd_plain(ct, vt, torch.from_numpy(g), H, W)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * np.abs(want).max())
    for a, b in ((dc.numpy(), np.asarray(dc_j)), (dw.numpy(), np.asarray(dw_j))):
        live = wgt[..., None] if a.ndim == 3 else wgt
        # The banded kernel reads no d weight for zero-weight rows outside
        # its band (its documented approximation); compare live rows.
        a, b = a * (live != 0), b * (live != 0)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-2 * np.abs(b).max())


# The forward kernel's partition (iwe_vote_banded_plain), case by case.
# Every case is ragged (M not a multiple of the chunk) unless it says
# otherwise, and has zero-weight padding at the end of each row.
BAND_CASES = ("sorted", "unsorted", "wide", "stragglers", "edges", "half",
              "padding_row", "hot", "w57")


def band_case(name, h=H, w=W, b=3, m=3001, chunk=256, seed=20):
    """(coords, weight, h, w, halves) of a band case: halves are the
    (start, stop) event ranges voted one by one (polarity halves)."""
    rng = np.random.default_rng(seed + BAND_CASES.index(name))
    w = 57 if name == "w57" else w
    m = 24 * chunk if name == "half" else m
    y = rng.uniform(-2, h + 1, (b, m))
    x = rng.uniform(-2, w + 1, (b, m))
    halves = [(0, m)]
    if name == "hot":                   # 24 events per row on one pixel,
        y[:, :24], x[:, :24] = h / 2 + 0.5, w / 2 + 0.5   # adjacent once sorted
    if name == "half":                  # two sorted halves of 12 chunks each
        halves = [(0, m // 2), (m // 2, m)]
        y = np.concatenate([np.sort(y[:, :m // 2]), np.sort(y[:, m // 2:])], 1)
    elif name != "unsorted":
        y = np.sort(y, axis=1)
    if name == "wide":                  # a flow of up to 3 bands' height
        y = y + 3 * (chunk * h / m) * np.sin(x / 3)
    if name == "edges":                 # the top and bottom rows and beyond
        y[:, ::16] = rng.choice([-1.0, -0.5, 0.0, 0.25, h - 1.5, h - 1.0,
                                 h - 0.5, float(h)], (b, (m + 15) // 16))
    coords = np.stack([y, x], -1).astype(np.float32)
    wgt = rng.uniform(0.2, 2.0, (b, m)).astype(np.float32)
    if name == "stragglers":            # 5% far outside, 5% anywhere inside
        far = rng.random((b, m)) < 0.1
        coords[far] = rng.choice([-1e9, 1e9], (int(far.sum()), 2))
        near = far & (rng.random((b, m)) < 0.5)
        coords[near] = rng.uniform(0, 1, (int(near.sum()), 2)) * (h - 1, w - 1)
    if name == "padding_row":
        wgt[1] = 0.0
    wgt[:, -40:] = 0.0
    return coords, wgt, h, w, halves


def live_taps(c, v, h, w):
    """Taps of live events (weight != 0) inside the image."""
    _, _, corners = iv._taps(c, h, w)
    return sum(int((mask & (v != 0)).sum()) for *_, mask in corners)


@pytest.mark.parametrize("name", BAND_CASES)
def test_banded_plain_matches_plain_and_jax(name):
    # atol 1e-5, the file's: the band and direct parts are the same f32
    # corner values, summed in another order.  Every live in-image tap is
    # counted once, band or direct.
    coords, wgt, h, w, halves = band_case(name)
    ct, vt = torch.from_numpy(coords), torch.from_numpy(wgt)
    for lo, hi in halves:
        c, v = ct[:, lo:hi], vt[:, lo:hi]          # batch-strided views
        got, n_band, n_direct = iv.iwe_vote_banded_plain(c, v, h, w,
                                                         chunk=256,
                                                         band_rows=8)
        want = iv.iwe_vote_fwd_plain(c, v, h, w)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5)
        jx = np.asarray(jax_direct(jnp.asarray(coords[:, lo:hi]),
                                   jnp.asarray(wgt[:, lo:hi]), h, w))
        np.testing.assert_allclose(got.numpy(), jx, rtol=0, atol=1e-5)
        assert n_band + n_direct == live_taps(c, v, h, w)
        # Sorted chunks use their band; a straggler inside the image takes
        # the direct path beside it; the unsorted and wide chunks' bands
        # hold too few of their taps.
        assert (n_band == 0) == (name in ("unsorted", "wide")), n_band
        assert n_direct > 0 or name not in ("stragglers", "unsorted", "wide")


def test_band_share_sorted_vs_unsorted():
    # Sorted chunks cover a few rows and fit their band; unsorted ones
    # spread over the image and fail the kernel's count test.
    h = 160
    coords, wgt, _, w, _ = band_case("sorted", h=h, chunk=128)
    ct, vt = torch.from_numpy(coords), torch.from_numpy(wgt)
    perm = torch.from_numpy(np.random.default_rng(3).permutation(3001))
    shares = []
    for c, v in ((ct, vt), (ct[:, perm], vt[:, perm])):
        _, n_band, n_direct = iv.iwe_vote_banded_plain(c, v, h, w, chunk=128,
                                                       band_rows=16)
        shares.append(n_band / (n_band + n_direct))
    assert shares[0] > 0.9 and shares[1] < 0.05, shares


def test_band_rows_fit_two_blocks_per_sm():
    # 39 rows of 644 f32 (640 + 4 of padding) at the flow-training width;
    # small images whole.
    assert iv.vote_band_rows(480, 640) == 39
    assert iv.vote_band_rows(40, 57) == 40
    assert iv.vote_band_rows(480, 640) * 644 * 4 <= iv.BAND_BYTES


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """The CUDA kernels against their plain versions on the card.

    Forward atol 1e-5: the atomics add a pixel's votes in another order
    on every run.  Backward rtol 1e-6 + atol 1e-6: the same f32
    expressions and no atomics, but nvcc contracts the sums of products
    into fused multiply-adds, which round once instead of twice (a few
    ulps of values up to ~10).  The forward also on the band cases at the
    flow-training size, where a band of 40 rows holds a sorted chunk's
    taps and not an unsorted or wide one's (W = 57 at H = 600: 449 rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for sort in (True, False):
        coords, wgt = make_inputs(7, b=3, m=20011, sort=sort)
        g = np.random.default_rng(8).normal(size=(3, H, W)).astype(np.float32)
        c = torch.from_numpy(coords).cuda()
        v = torch.from_numpy(wgt).cuda()
        gt = torch.from_numpy(g).cuda()
        before = (iv.iwe_vote_fwd.launches, iv.iwe_vote_bwd.launches)
        out = iv.iwe_vote_fwd(c, v, H, W)
        dc, dw = iv.iwe_vote_bwd(c, v, gt, H, W)
        torch.cuda.synchronize()
        assert (iv.iwe_vote_fwd.launches, iv.iwe_vote_bwd.launches) == (
            before[0] + 1, before[1] + 1)
        torch.testing.assert_close(out, iv.iwe_vote_fwd_plain(c, v, H, W),
                                   rtol=0, atol=1e-5)
        dc_p, dw_p = iv.iwe_vote_bwd_plain(c, v, gt, H, W)
        torch.testing.assert_close(dc, dc_p, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(dw, dw_p, rtol=1e-6, atol=1e-6)
    for name in BAND_CASES:
        coords, wgt, h, w, halves = band_case(
            name, h=600 if name == "w57" else 480, w=640, m=60011,
            chunk=iv.VOTE_CHUNK)
        ct = torch.from_numpy(coords).cuda()
        vt = torch.from_numpy(wgt).cuda()
        for lo, hi in halves:
            c, v = ct[:, lo:hi], vt[:, lo:hi]
            out = iv.iwe_vote_fwd(c, v, h, w)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, iv.iwe_vote_fwd_plain(c, v, h, w),
                                       rtol=0, atol=1e-5, msg=name)
            _, n_band, n_direct = iv.iwe_vote_banded_plain(c, v, h, w)
            assert n_band + n_direct == live_taps(c, v, h, w)
            if name in ("sorted", "unsorted"):     # both paths ran
                assert (n_band > 0) == (name == "sorted")

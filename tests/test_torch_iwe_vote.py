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

import functools

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
    from motionpriorcmax_tpu.losses import FocusLossConfig as JaxFocusCfg
    from motionpriorcmax_tpu.losses.focus import make_iwes as jax_make_iwes
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


# Backward edge cases, held against the JAX vote's autodiff here and
# against the plain version on the card (check_bwd_layouts_on_card): a tap
# pair's first column even or odd, pairs on the left and right edges
# (x1 = -1 and x1 = W - 1), on the top and bottom rows (y1 = -1 and
# y1 = H - 1), widths that are not a multiple of 4, and zero weights.
BWD_CASES = ("x1_even", "x1_odd", "edges", "rows", "w57", "w61",
             "zero_weight")


def bwd_case(name, b=2, m=777, h=H, w=W, seed=30):
    """(coords, weight, h, w) of a backward case."""
    rng = np.random.default_rng(seed + BWD_CASES.index(name))
    w = {"w57": 57, "w61": 61}.get(name, w)
    y = rng.uniform(0, h - 1, (b, m))              # both tap rows inside
    x = rng.uniform(-2, w + 1, (b, m))
    frac = rng.uniform(0.01, 0.99, (b, m))
    if name in ("x1_even", "x1_odd"):
        x = (rng.integers(0, (w - 1) // 2, (b, m)) * 2
             + (name == "x1_odd") + frac)
    if name == "edges":
        x = rng.choice([-1, w - 1], (b, m)) + frac
    if name == "rows":
        y = rng.choice([-1, h - 1], (b, m)) + frac
    if name in ("w57", "w61", "zero_weight"):
        y = rng.uniform(-2, h + 1, (b, m))
    coords = np.stack([y, x], -1).astype(np.float32)
    wgt = rng.uniform(0.2, 2.0, (b, m)).astype(np.float32)
    if name == "zero_weight":
        wgt[:, ::2] = 0.0
    return coords, wgt, h, w


@pytest.mark.parametrize("name", BWD_CASES)
def test_bwd_edge_cases_match_jax(name):
    # The wrapper (its plain version on the CPU) against the JAX 'direct'
    # vote's autodiff at the file's atol 1e-5, with and without d weight;
    # the taps on the edges and rows outside the image read nothing.
    coords, wgt, h, w = bwd_case(name)
    g = np.random.default_rng(40).normal(size=(2, h, w)).astype(np.float32)
    ct, vt, gt = (torch.from_numpy(a) for a in (coords, wgt, g))
    dc_j, dw_j = jax.grad(lambda c, v: jnp.sum(jax_direct(c, v, h, w) * g),
                          argnums=(0, 1))(jnp.asarray(coords),
                                          jnp.asarray(wgt))
    for need_dweight in (True, False):
        dc, dw = iv.iwe_vote_bwd(ct, vt, gt, h, w, need_dweight)
        np.testing.assert_allclose(dc.numpy(), np.asarray(dc_j), rtol=0,
                                   atol=1e-5)
        assert (dw is None) == (not need_dweight)
        if need_dweight:
            np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), rtol=0,
                                       atol=1e-5)
    if name == "zero_weight":
        assert not dc[:, ::2].any()
    else:
        assert np.abs(np.asarray(dc_j)).max() > 0


@functools.lru_cache(maxsize=None)
def strided_case():
    """Events whose second polarity half starts at an odd offset (301 of
    901), a [B, 2, H, W] cotangent, and the JAX Pallas vote's VJP of each
    half against its plane (f32 tiles, interpret mode)."""
    coords, wgt = make_inputs(11, m=901)
    giwes = np.random.default_rng(12).normal(size=(2, 2, H, W)).astype(
        np.float32)
    want = []
    for k, (lo, hi) in enumerate(((0, 301), (301, 901))):
        def loss(c, v, k=k):
            return jnp.sum(iwe_vote_pallas(c, v, H, W, jnp.float32, True)
                           * giwes[:, k])
        dc, dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(coords[:, lo:hi]),
                                                jnp.asarray(wgt[:, lo:hi]))
        want.append((lo, hi, np.asarray(dc), np.asarray(dw)))
    return coords, wgt, giwes, want


@pytest.mark.parametrize("need_dweight", [True, False])
def test_bwd_takes_strided_cotangent_and_odd_half(need_dweight):
    # autograd hands each polarity half of make_iwes' stack a select(1, k)
    # of the [B, 2, H, W] cotangent, and the negative half of the events
    # starts num_pos_events in (odd here): the wrapper takes both as they
    # lie and gives the contiguous call's values.  atol 1e-5 against the
    # Pallas VJP in f32: the same products, its sums in another order.
    coords, wgt, giwes, want = strided_case()
    ct, vt, gt = (torch.from_numpy(a) for a in (coords, wgt, giwes))
    for k, (lo, hi, dc_j, dw_j) in enumerate(want):
        c, v, g = ct[:, lo:hi], vt[:, lo:hi], gt.select(1, k)
        assert not g.is_contiguous() and c.storage_offset() == 2 * lo
        dc, dw = iv.iwe_vote_bwd(c, v, g, H, W, need_dweight)
        dc0, dw0 = iv.iwe_vote_bwd(c.contiguous(), v.contiguous(),
                                   g.contiguous(), H, W, need_dweight)
        assert torch.equal(dc, dc0)
        np.testing.assert_allclose(dc.numpy(), dc_j, rtol=0, atol=1e-5)
        if need_dweight:
            assert torch.equal(dw, dw0)
            np.testing.assert_allclose(dw.numpy(), dw_j, rtol=0, atol=1e-5)
        else:
            assert dw is None and dw0 is None


def test_make_iwes_grad_matches_jax():
    # The autograd path of the focus loss: make_iwes votes the two
    # polarity halves (the second at an odd event offset) and stacks them;
    # the gradient of sum(iwes * G) with respect to the warped (y, x)
    # matches the JAX make_iwes' at atol 1e-5 of its largest entry (f32
    # votes and blur summed in another order).
    from motionpriorcmax_tpu_torch.losses import FocusLossConfig
    from motionpriorcmax_tpu_torch.losses.focus import make_iwes

    rng = np.random.default_rng(50)
    b, m, npos = 2, 801, 401
    ev = np.zeros((b, m, 6), np.float32)
    ev[..., 0] = rng.uniform(0, H, (b, m))
    ev[..., 1] = rng.uniform(0, W, (b, m))
    ev[..., 2] = rng.uniform(0, 1, (b, m))
    ev[:, :npos, 3] = 1.0
    ev[..., 5] = (rng.random((b, m)) < 0.9).astype(np.float32)
    warped_yx = (ev[:, None, :, :2]
                 + rng.normal(0, 3, (b, 1, m, 2)).astype(np.float32))
    g = rng.normal(size=(b, 2, H, W)).astype(np.float32)
    t_ref = np.asarray([0.37], np.float32)
    kw = dict(image_shape=(H, W), polarity_aware_batching=True)

    def jloss(yx):
        warped = jnp.concatenate(
            [yx, jnp.broadcast_to(ev[:, None, :, 2:], (b, 1, m, 4))], -1)
        return jnp.sum(jax_make_iwes(JaxFocusCfg(**kw), warped,
                                     jnp.asarray(t_ref), npos) * g)

    g_j = np.asarray(jax.grad(jloss)(jnp.asarray(warped_yx)))
    yx = torch.from_numpy(warped_yx).requires_grad_()
    iwes = make_iwes(FocusLossConfig(**kw), yx, torch.from_numpy(ev),
                     torch.from_numpy(t_ref), npos)
    assert iwes.shape == (b, 2, H, W)
    (iwes * torch.from_numpy(g)).sum().backward()
    assert np.abs(g_j).max() > 0
    np.testing.assert_allclose(yx.grad.numpy(), g_j, rtol=0,
                               atol=1e-5 * np.abs(g_j).max())


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


def skewed_inputs(seed, b=3, m=40011, h=480, w=640):
    """Half the events in one 16 x 64 region and 1% on one pixel, the
    rest anywhere, in random order."""
    rng = np.random.default_rng(seed)
    y, x = rng.uniform(-2, h + 1, (b, m)), rng.uniform(-2, w + 1, (b, m))
    hot = rng.random((b, m)) < 0.5
    y = np.where(hot, 200 + rng.uniform(0, 16, (b, m)), y)
    x = np.where(hot, 300 + rng.uniform(0, 64, (b, m)), x)
    pixel = rng.random((b, m)) < 0.01
    y, x = np.where(pixel, 207.5, y), np.where(pixel, 331.25, x)
    wgt = rng.uniform(0.2, 2.0, (b, m)).astype(np.float32)
    wgt[:, -40:] = 0.0
    return np.stack([y, x], -1).astype(np.float32), wgt, h, w


def check_bwd_layouts_on_card():
    """The backward kernel against its plain version on the layouts the
    path and its edges give it: each polarity half of a [B, 2, H, W]
    cotangent (a batch stride of 2 H W, read where it lies), coords and
    weight views at an 8-byte but not 16-byte aligned start (1 event in),
    the cases of BWD_CASES, a skewed batch, an 800 x 1024 image and
    sorted events;
    with and without d weight, the same bits in two calls and in the
    contiguous call."""
    cases = [bwd_case(name, b=3, m=20011) for name in BWD_CASES]
    cases.append(skewed_inputs(9))
    cases.append(bwd_case("x1_odd", b=3, m=20011, h=800, w=1024))
    coords, wgt = make_inputs(10, b=3, m=20011, sort=True)
    cases.append((coords, wgt, H, W))
    for coords, wgt, h, w in cases:
        ct = torch.from_numpy(coords).cuda()
        vt = torch.from_numpy(wgt).cuda()
        giwes = torch.from_numpy(np.random.default_rng(41).normal(
            size=(3, 2, h, w)).astype(np.float32)).cuda()
        for lo, k in ((0, 0), (1, 1)):
            c, v, g = ct[:, lo:], vt[:, lo:], giwes.select(1, k)
            assert (c.data_ptr() % 16 == 8) == (lo == 1)
            for need_dweight in (True, False):
                before = iv.iwe_vote_bwd.launches
                dc, dw = iv.iwe_vote_bwd(c, v, g, h, w, need_dweight)
                dc2, dw2 = iv.iwe_vote_bwd(c, v, g, h, w, need_dweight)
                dc3, dw3 = iv.iwe_vote_bwd(c.contiguous(), v.contiguous(),
                                           g.contiguous(), h, w, need_dweight)
                torch.cuda.synchronize()
                assert iv.iwe_vote_bwd.launches == before + 3
                dc_p, dw_p = iv.iwe_vote_bwd_plain(c, v, g, h, w,
                                                   need_dweight)
                torch.testing.assert_close(dc, dc_p, rtol=1e-6, atol=1e-6)
                assert torch.equal(dc.view(torch.int32), dc2.view(torch.int32))
                assert torch.equal(dc.view(torch.int32), dc3.view(torch.int32))
                if need_dweight:
                    torch.testing.assert_close(dw, dw_p, rtol=1e-6, atol=1e-6)
                    assert torch.equal(dw.view(torch.int32),
                                       dw2.view(torch.int32))
                    assert torch.equal(dw.view(torch.int32),
                                       dw3.view(torch.int32))
                else:
                    assert dw is None and dw_p is None


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """The CUDA kernels against their plain versions on the card.

    Forward atol 1e-5: the atomics add a pixel's votes in another order
    on every run.  Backward rtol 1e-6 + atol 1e-6: the same f32
    expressions and no atomics, but nvcc contracts the sums of products
    into fused multiply-adds, which round once instead of twice (a few
    ulps of values up to ~10).  The backward also on the layouts of
    check_bwd_layouts_on_card.  The forward also on the band cases at the
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
    check_bwd_layouts_on_card()
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

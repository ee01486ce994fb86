"""The corr-window lookup's backward (the port's `corr_window_lookup_bwd`
and `CorrPyramidLookup`) vs `jax.vjp` of the JAX package's lookup through
its Pallas kernel (interpret mode, the TPU kernel `_vjp_bwd` included).

Inputs are numpy arrays from a seed, handed to both sides; coordinates sit
at least 1e-3 away from integers (the bilinear fractions jump there), some
partly outside the maps and some so far out that the port's origin clamp
applies (all-zero windows, zero coordinate gradients).  On the CPU the port
runs the plain backward; the kernel itself is held against it by the
`cuda`-marked tests, on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_corr_window_bwd.py

Tolerances: d corr 1e-6 absolute for f32 volumes (four weighted cotangent
terms per tap, summed in another order) and one bf16 rounding step (at
most 2^-7 of the value) for bf16 volumes, whose d corr is the f32 sum
rounded; d cx, d cy 1e-5 of their largest magnitude (81-term sums).
"""

import numpy as np
import pytest
import torch

from motionpriorcmax_tpu_torch.models.raft_spline import corr as tcorr
from motionpriorcmax_tpu_torch.ops.cuda import corr_window as cw

try:
    import jax
    import jax.numpy as jnp

    from motionpriorcmax_tpu.models.raft_spline import corr as jcorr
except ImportError:         # the GPU machine: only the cuda tests run there
    jax = jnp = jcorr = None

R = 4
K = (2 * R + 1) ** 2


def _coords(rng, shape, lo, hi):
    """Uniform in [lo, hi) with the fraction kept inside [1e-3, 1 - 1e-3]."""
    c = rng.uniform(lo, hi, shape)
    frac = np.clip(c - np.floor(c), 1e-3, 1 - 1e-3)
    return (np.floor(c) + frac).astype(np.float32)


def _level(rng, t, b, h1, w1, h2, w2):
    corr = rng.normal(size=(t, b, h1 * w1, h2, w2)).astype(np.float32)
    cx = _coords(rng, (t, b, h1 * w1), -8, w2 + 6)
    cy = _coords(rng, (t, b, h1 * w1), -8, h2 + 6)
    cx[0, 0, :3] = [-500.25, w2 + 700.5, 3.5]      # clamped, clamped, inside
    cy[0, 0, :3] = [2.5, 2.5, h2 + 900.75]         # ..., ..., clamped
    return corr, cx, cy


def _jax_level_vjp(corr, cx, cy, g_feat, dtype):
    """jax.vjp of _window_lookup (Pallas kernel, interpret mode), jitted,
    for one level flattened to [N, H2, W2] maps: (d corr, d cx, d cy)."""
    n = cx.size
    h2, w2 = corr.shape[-2:]

    def f(c, x, y):
        return jcorr._window_lookup(c, x, y, R, "pallas")

    grads = jax.jit(lambda c, x, y, ct: jax.vjp(f, c, x, y)[1](ct))(
        jnp.asarray(corr.reshape(n, h2, w2)).astype(dtype),
        jnp.asarray(cx.reshape(n)), jnp.asarray(cy.reshape(n)),
        jnp.asarray(g_feat))
    return [np.asarray(a.astype(jnp.float32)) for a in grads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_level_matches_jax_vjp(dtype):
    rng = np.random.default_rng(0)
    t, b, h1, w1, h2, w2 = 2, 2, 3, 4, 7, 9
    corr, cx, cy = _level(rng, t, b, h1, w1, h2, w2)
    chan_off, c_total = K, 3 * K
    g = rng.normal(size=(b, c_total, h1, w1)).astype(np.float32)
    # The level's slab of the cotangent, as the forward wrote it: channel
    # chan_off + t * K + k at query q of batch b.
    g_feat = (g.reshape(b, c_total, h1 * w1)[:, chan_off:chan_off + t * K]
              .reshape(b, t, K, h1 * w1).transpose(1, 0, 3, 2)
              .reshape(-1, K))
    want = _jax_level_vjp(corr, cx, cy, g_feat, getattr(jnp, dtype))

    corr_t = torch.from_numpy(corr).to(getattr(torch, dtype))
    before = cw.corr_window_lookup_bwd.launches
    d_corr, d_cx, d_cy = cw.corr_window_lookup_bwd(
        corr_t, torch.from_numpy(cx), torch.from_numpy(cy), R,
        torch.from_numpy(g), chan_off)
    assert cw.corr_window_lookup_bwd.launches == before  # plain on the CPU
    assert d_corr.dtype == corr_t.dtype and d_corr.shape == corr_t.shape
    got = d_corr.float().numpy().reshape(want[0].shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, want[0], rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want[0], rtol=2 ** -7, atol=1e-6)
    for got_c, want_c in ((d_cx, want[1]), (d_cy, want[2])):
        scale = np.abs(want_c).max()
        np.testing.assert_allclose(got_c.numpy().reshape(-1), want_c, rtol=0,
                                   atol=1e-5 * scale)
    # The clamped windows are all zero: no coordinate gradient.
    assert d_cx[0, 0, 0] == 0 and d_cx[0, 0, 1] == 0 and d_cy[0, 0, 2] == 0
    assert want[1][0] == 0 and want[1][1] == 0 and want[2][2] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pyramid_lookup_gradients_match_jax(dtype):
    """Autograd through CorrPyramidLookup (levels 1-3, the per-level 1/2^l
    scale outside the Function) against jax.vjp of lookup_corr_pyramid with
    the Pallas impl: every level volume's and the coordinates' gradient."""
    rng = np.random.default_rng(1)
    t0, b, h1, w1 = 3, 1, 4, 5
    levels = [(0, 1, 2), (1, 2), (2,)]
    shapes = [(10, 12), (5, 6), (2, 3)]
    vols = [rng.normal(size=(len(idx), b, h1 * w1) + hw).astype(np.float32)
            for idx, hw in zip(levels, shapes)]
    base = np.stack(np.meshgrid(np.arange(w1), np.arange(h1), indexing="xy"))
    coords = (base[None, None] + rng.normal(scale=4.0, size=(t0, b, 2, h1, w1)))
    coords = _coords(rng, coords.shape, 0, 1) + np.floor(coords).astype(
        np.float32)
    coords[0, 0, 0, 0, :2] = [-900.5, 700.25]      # origin clamp at every level
    g = rng.normal(size=(b, sum(map(len, levels)) * K, h1, w1)).astype(np.float32)

    jdt = getattr(jnp, dtype)

    def f(vs, c):
        pyr = [(idx, v.astype(jdt)) for idx, v in zip(levels, vs)]
        return jcorr.lookup_corr_pyramid(pyr, c, R, "pallas")

    d_vols_j, d_coords_j = jax.jit(
        lambda vs, c, ct: jax.vjp(f, vs, c)[1](ct))(
            [jnp.asarray(v) for v in vols], jnp.asarray(coords), jnp.asarray(g))

    tdt = getattr(torch, dtype)
    vols_t = [torch.from_numpy(v).to(tdt).requires_grad_() for v in vols]
    coords_t = torch.from_numpy(coords).requires_grad_()
    out = tcorr.lookup_corr_pyramid(list(zip(levels, vols_t)), coords_t, R)
    out.backward(torch.from_numpy(g))
    for v_t, d_j in zip(vols_t, d_vols_j):
        got, want = v_t.grad.float().numpy(), np.asarray(d_j, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
    want = np.asarray(d_coords_j)
    np.testing.assert_allclose(coords_t.grad.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert torch.all(coords_t.grad[0, 0, :, 0, 0] == 0)


def test_plain_backward_is_autograd_of_plain_forward():
    # The plain backward against torch autograd through the plain forward
    # (gather + bilinear combine) with f64 volume and coordinates: the same
    # function, to the f32 rounding of the plain backward's coordinates.
    rng = np.random.default_rng(2)
    t, b, h1, w1, h2, w2 = 2, 1, 2, 3, 6, 8
    corr, cx, cy = _level(rng, t, b, h1, w1, h2, w2)
    g = torch.from_numpy(rng.normal(size=(b, t * K, h1, w1)))
    c64 = torch.from_numpy(corr).double().requires_grad_()
    x64 = torch.from_numpy(cx).double().requires_grad_()
    y64 = torch.from_numpy(cy).double().requires_grad_()
    feat = cw.window_lookup_plain(c64.reshape(-1, h2, w2), x64.reshape(-1),
                                  y64.reshape(-1), R)
    feat = feat.double().reshape(t, b, h1 * w1, K).permute(1, 0, 3, 2)
    feat.reshape(b, t * K, h1, w1).backward(g)
    d_corr, d_cx, d_cy = cw.corr_window_lookup_bwd_plain(
        c64.detach(), x64.detach().float(), y64.detach().float(), R,
        g.float(), 0)
    np.testing.assert_allclose(d_corr.numpy(), c64.grad.numpy(), atol=1e-5)
    np.testing.assert_allclose(d_cx.numpy(), x64.grad.numpy(), atol=1e-4)
    np.testing.assert_allclose(d_cy.numpy(), y64.grad.numpy(), atol=1e-4)


def test_pyramid_lookup_without_grad_saves_nothing_and_matches_forward():
    # Under no_grad the Function is the forward alone: the same slab as the
    # per-level wrapper writes.
    rng = np.random.default_rng(3)
    corr, cx, cy = _level(rng, 2, 2, 3, 4, 7, 9)
    corr_t, cx_t, cy_t = map(torch.from_numpy, (corr, cx, cy))
    with torch.no_grad():
        got = cw.CorrPyramidLookup.apply(R, 3, 4, corr_t, cx_t, cy_t)
    want = cw.corr_window_lookup(corr_t, cx_t, cy_t, R,
                                 torch.zeros(2, 2 * K, 3, 4), 0)
    assert not got.requires_grad
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _card_level(gen, t, b, q, h2, w2, dtype, dev):
    corr = torch.randn(t, b, q, h2, w2, generator=gen).to(dtype).to(dev)
    cx = (torch.rand(t, b, q, generator=gen) * (w2 + 16) - 8)
    cy = (torch.rand(t, b, q, generator=gen) * (h2 + 16) - 8)
    cx[0, 0, :3] = torch.tensor([1e12, -1e12, float(w2) - 0.5])
    return corr, cx.to(dev), cy.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w2", [16, 13], ids=["vec4", "scalar"])
def test_bwd_kernel_matches_plain_on_card(dtype, w2):
    # Kernel vs plain on the card, both summing in f32 (the kernel with
    # fused multiply-adds): d corr 1e-5 absolute at unit-scale cotangents
    # (bf16: one rounding step, 2^-7 of the value), d cx / d cy 1e-5 of
    # their largest value.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)
    tdt = getattr(torch, dtype)
    t, b, h1, w1, h2 = 3, 2, 5, 7, 12
    corr, cx, cy = _card_level(gen, t, b, h1 * w1, h2, w2, tdt, dev)
    g = torch.randn(b, 2 * t * K, h1, w1, generator=gen).to(dev)
    before = cw.corr_window_lookup_bwd.launches
    got = cw.corr_window_lookup_bwd(corr, cx, cy, R, g, t * K)
    torch.cuda.synchronize()
    assert cw.corr_window_lookup_bwd.launches == before + 1
    want = cw.corr_window_lookup_bwd_plain(corr, cx, cy, R, g, t * K)
    rtol = 2 ** -7 if dtype == "bfloat16" else 0.0
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=rtol,
                               atol=1e-5)
    for a, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()))


@pytest.mark.cuda
def test_pyramid_autograd_launches_both_kernels_on_card():
    # A CUDA volume under autograd runs the forward and the backward kernel
    # once per level, and matches the CPU's plain versions.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(5)
    t0, b, h1, w1 = 2, 2, 4, 6
    levels = [((0, 1), (16, 24)), ((1,), (8, 12))]
    vols = [torch.randn(len(idx), b, h1 * w1, *hw, generator=gen)
            for idx, hw in levels]
    coords = torch.rand(t0, b, 2, h1, w1, generator=gen) * 20 - 2
    g = torch.randn(b, 3 * K, h1, w1, generator=gen)
    grads = {}
    for dev in ("cpu", "cuda"):
        vs = [v.detach().clone().to(dev).requires_grad_() for v in vols]
        c = coords.detach().clone().to(dev).requires_grad_()
        fwd0 = cw.corr_window_lookup.launches
        bwd0 = cw.corr_window_lookup_bwd.launches
        out = tcorr.lookup_corr_pyramid(
            [(idx, v) for (idx, _), v in zip(levels, vs)], c, R)
        out.backward(g.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert cw.corr_window_lookup.launches == fwd0 + 2
            assert cw.corr_window_lookup_bwd.launches == bwd0 + 2
        grads[dev] = [x.grad.cpu() for x in vs + [c]]
    for a, w in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, w, rtol=0,
                                   atol=1e-5 * max(1.0, float(w.abs().max())))

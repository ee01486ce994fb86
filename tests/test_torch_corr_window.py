"""Port's corr-window lookup vs the JAX package's Pallas kernel and lookup.

JAX runs on the CPU (tests/conftest.py); the Pallas kernel runs in interpret
mode.  Inputs are numpy arrays from a seed, handed to both sides.  On the CPU
the port's wrapper runs its plain version; the kernel itself is compared
with that plain version by the `cuda`-marked test, on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_corr_window.py

The GPU machine has no JAX, so there the JAX imports are absent and only the
`cuda` test is selected (tests/conftest.py imports JAX, hence --noconftest).
"""

import numpy as np
import pytest
import torch

from motionpriorcmax_tpu_torch.ops.cuda import corr_window as cw

try:
    import jax.numpy as jnp

    from motionpriorcmax_tpu.models.raft_spline.corr import _window_lookup
    from motionpriorcmax_tpu.ops.pallas.corr_window import corr_window_pallas
except ImportError:         # the GPU machine: only the cuda test runs there
    jnp = _window_lookup = corr_window_pallas = None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_extract_windows_equals_pallas_interpret(dtype):
    # A pure selection: exact in any dtype, including out-of-range origins.
    rng = np.random.default_rng(0)
    n, h2, w2, win = 37, 7, 11, 10
    corr = rng.normal(size=(n, h2, w2)).astype(np.float32)
    rows0 = rng.integers(-12, h2 + 3, n).astype(np.int32)
    cols0 = rng.integers(-12, w2 + 3, n).astype(np.int32)
    corr_j = jnp.asarray(corr).astype(getattr(jnp, dtype))
    want = np.asarray(corr_window_pallas(corr_j, jnp.asarray(rows0),
                                         jnp.asarray(cols0), win, True))
    corr_t = torch.from_numpy(corr).to(getattr(torch, dtype))
    got = cw.extract_windows(corr_t, torch.from_numpy(rows0),
                             torch.from_numpy(cols0), win)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("impl", ["pallas", "einsum"])
def test_window_lookup_plain_matches_jax(impl):
    # atol 1e-6: the same f32 arithmetic on a selection; only the order of
    # the four weighted terms' rounding can differ.
    rng = np.random.default_rng(1)
    n, h2, w2, r = 50, 9, 13, 4
    corr = rng.normal(size=(n, h2, w2)).astype(np.float32)
    cx = rng.uniform(-8, w2 + 6, n).astype(np.float32)
    cy = rng.uniform(-8, h2 + 6, n).astype(np.float32)
    want = np.asarray(_window_lookup(jnp.asarray(corr), jnp.asarray(cx),
                                     jnp.asarray(cy), r, impl))
    got = cw.window_lookup_plain(torch.from_numpy(corr), torch.from_numpy(cx),
                                 torch.from_numpy(cy), r)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_far_out_coordinates_give_zero_windows():
    # Coordinates far outside the map (beyond int32 after the floor) give
    # all-zero features: the origin is clamped before the integer cast.
    corr = torch.randn(4, 6, 8, generator=torch.Generator().manual_seed(0))
    cx = torch.tensor([1e12, -1e12, 3.5, -7.0])
    cy = torch.tensor([2.0, 2.0, -1e12, 1e12])
    got = cw.window_lookup_plain(corr, cx, cy, 4)
    assert torch.equal(got, torch.zeros_like(got))


def test_wrapper_writes_its_channel_slab():
    # The wrapper's layout: channel chan_off + t*K + k of [B, C, h1, w1],
    # and nothing outside its slab.
    rng = np.random.default_rng(2)
    t, b, h1, w1, h2, w2, r = 2, 3, 4, 5, 6, 7, 4
    k = (2 * r + 1) ** 2
    corr = rng.normal(size=(t, b, h1 * w1, h2, w2)).astype(np.float32)
    cx = rng.uniform(-2, w2 + 2, (t, b, h1 * w1)).astype(np.float32)
    cy = rng.uniform(-2, h2 + 2, (t, b, h1 * w1)).astype(np.float32)
    out = torch.full((b, 3 * k + t * k, h1, w1), 7.0)
    before = cw.corr_window_lookup.launches
    cw.corr_window_lookup(torch.from_numpy(corr), torch.from_numpy(cx),
                          torch.from_numpy(cy), r, out, 3 * k)
    feat = np.asarray(_window_lookup(jnp.asarray(corr.reshape(-1, h2, w2)),
                                     jnp.asarray(cx.reshape(-1)),
                                     jnp.asarray(cy.reshape(-1)), r, "einsum"))
    want = feat.reshape(t, b, h1, w1, k).transpose(1, 0, 4, 2, 3)
    np.testing.assert_allclose(out[:, 3 * k:].numpy(),
                               want.reshape(b, t * k, h1, w1), atol=1e-6)
    assert torch.all(out[:, :3 * k] == 7.0)
    assert cw.corr_window_lookup.launches == before  # no kernel on the CPU


def test_wrapper_rejects_bad_inputs():
    corr = torch.zeros(1, 1, 4, 3, 3)
    cxy = torch.zeros(1, 1, 4)
    out = torch.zeros(1, 81, 2, 2)
    with pytest.raises(TypeError):
        cw.corr_window_lookup(corr.double(), cxy, cxy, 4, out, 0)
    with pytest.raises(ValueError):
        cw.corr_window_lookup(corr, cxy, cxy, 4, out, 1)      # slab overflows
    with pytest.raises(ValueError):
        cw.corr_window_lookup(corr, cxy[..., :3], cxy, 4, out, 0)
    with pytest.raises(ValueError):
        cw.corr_window_lookup(corr, cxy, cxy, 8, torch.zeros(1, 289, 2, 2), 0)
    with pytest.raises(ValueError, match="radius 4"):         # built for r=4 only
        cw.corr_window_lookup(corr, cxy, cxy, 2, torch.zeros(1, 25, 2, 2), 0)


def test_cuda_dispatch_raises_on_requires_grad(monkeypatch):
    # On a CUDA tensor the wrapper launches the kernel or raises; it never
    # falls back.  Mock the dispatch so that CPU tensors take the CUDA
    # branch: the in-place slab writer carries no gradient, so a volume
    # under autograd must raise before any build (gradients go through
    # CorrPyramidLookup).
    monkeypatch.setattr(cw, "_is_cuda", lambda x: True)

    def no_build(name):
        raise AssertionError("the kernel library must not be loaded")

    import motionpriorcmax_tpu_torch.ops.cuda.build as build

    monkeypatch.setattr(build, "load_library", no_build)
    corr = torch.zeros(1, 1, 4, 3, 3, requires_grad=True)
    cxy = torch.zeros(1, 1, 4)
    out = torch.zeros(1, 81, 2, 2)
    with pytest.raises(ValueError, match="CorrPyramidLookup"):
        cw.corr_window_lookup(corr, cxy, cxy, 4, out, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(dtype):
    # Kernel vs plain at small shapes with out-of-range coordinates; both
    # accumulate in f32, the kernel may fuse multiply-adds: atol 1e-5 at
    # unit-scale values.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(3)
    t, b, h1, w1, h2, w2, r = 3, 2, 5, 7, 12, 16, 4
    k = (2 * r + 1) ** 2
    corr = torch.randn(t, b, h1 * w1, h2, w2, generator=g).to(getattr(torch, dtype))
    cx = torch.rand(t, b, h1 * w1, generator=g) * (w2 + 16) - 8
    cy = torch.rand(t, b, h1 * w1, generator=g) * (h2 + 16) - 8
    cx[0, 0, :3] = torch.tensor([1e12, -1e12, float(w2)])
    want = cw.corr_window_lookup_plain(corr, cx, cy, r,
                                       torch.zeros(b, 2 * t * k, h1, w1), t * k)
    dev = torch.device("cuda")
    before = cw.corr_window_lookup.launches
    got = cw.corr_window_lookup(corr.to(dev), cx.to(dev), cy.to(dev), r,
                                torch.zeros(b, 2 * t * k, h1, w1, device=dev),
                                t * k)
    torch.cuda.synchronize()
    assert cw.corr_window_lookup.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)

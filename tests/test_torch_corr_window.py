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

from motionpriorcmax_tpu_torch.models.raft_spline import corr as tcorr
from motionpriorcmax_tpu_torch.ops.cuda import corr_window as cw

try:
    import jax
    import jax.numpy as jnp

    from motionpriorcmax_tpu.models.raft_spline import corr as jcorr
    from motionpriorcmax_tpu.models.raft_spline.corr import _window_lookup
    from motionpriorcmax_tpu.ops.pallas.corr_window import corr_window_pallas
except ImportError:         # the GPU machine: only the cuda tests run there
    jax = jnp = jcorr = _window_lookup = corr_window_pallas = None


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


# A small pyramid whose level 2 is 10 wide and level 3 5 wide: rows of 40
# and 20 bytes in f32, 20 and 10 in bf16 (odd widths put bf16 pairs across
# rows on the card).
PYR_LEVELS = [(0, 1, 2), (1, 2), (2,)]
PYR_SHAPES = [(12, 20), (6, 10), (3, 5)]


def _pyramid(rng, b=2, h1=3, w1=4):
    vols = [rng.normal(size=(len(idx), b, h1 * w1) + hw).astype(np.float32)
            for idx, hw in zip(PYR_LEVELS, PYR_SHAPES)]
    base = np.stack(np.meshgrid(np.arange(w1), np.arange(h1), indexing="xy"))
    coords = (base[None, None] * 3.0
              + rng.normal(scale=4.0, size=(3, b, 2, h1, w1))).astype(np.float32)
    coords[0, 0, 0, 0, :2] = [-900.5, 700.25]      # origin clamp at every level
    return vols, coords


def test_levels_plain_equals_per_level_and_jax_pyramid():
    # The fused entry's plain version is the per-level plain calls, slab by
    # slab (bitwise), and the port's pyramid lookup through it matches the
    # JAX lookup_corr_pyramid (einsum impl) to 1e-6: the same f32
    # arithmetic on a selection.
    rng = np.random.default_rng(4)
    vols, coords = _pyramid(rng)
    b, h1, w1 = 2, 3, 4
    levels, off = [], 0
    for lvl, (idx, v) in enumerate(zip(PYR_LEVELS, vols)):
        sel = coords[list(idx)] / 2.0 ** lvl
        cx = torch.from_numpy(np.ascontiguousarray(
            sel[:, :, 0].reshape(len(idx), b, h1 * w1)))
        cy = torch.from_numpy(np.ascontiguousarray(
            sel[:, :, 1].reshape(len(idx), b, h1 * w1)))
        levels.append((torch.from_numpy(v), cx, cy, off))
        off += len(idx) * 81
    fused = torch.full((b, off, h1, w1), float("nan"))
    per_level = torch.full_like(fused, float("nan"))
    before = cw.corr_window_lookup.launches
    cw.corr_window_lookup_levels(levels, 4, fused)
    for corr, cx, cy, chan_off in levels:
        cw.corr_window_lookup_plain(corr, cx, cy, 4, per_level, chan_off)
    assert cw.corr_window_lookup.launches == before  # no kernel on the CPU
    assert torch.equal(fused, per_level)

    got = tcorr.lookup_corr_pyramid(
        [(idx, torch.from_numpy(v)) for idx, v in zip(PYR_LEVELS, vols)],
        torch.from_numpy(coords), 4)
    want = np.asarray(jax.jit(lambda vs, c: jcorr.lookup_corr_pyramid(
        list(zip(PYR_LEVELS, vs)), c, 4, "einsum"))(
            [jnp.asarray(v) for v in vols], jnp.asarray(coords)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    torch.testing.assert_close(got, fused, rtol=0, atol=1e-6)


def test_pyramid_lookup_launches_once_forward_once_per_level_backward(
        monkeypatch):
    # On CUDA tensors CorrPyramidLookup makes one forward launch for all
    # levels and one backward launch per level.  Mock the dispatch so that
    # CPU tensors take the CUDA branch, with the launches replaced by the
    # plain versions: the counters and the calls show the launch pattern,
    # and the result is the plain path's.
    rng = np.random.default_rng(5)
    vols, coords = _pyramid(rng)
    g = torch.from_numpy(rng.normal(size=(2, 6 * 81, 3, 4)).astype(np.float32))

    def run():
        vs = [torch.from_numpy(v).requires_grad_() for v in vols]
        c = torch.from_numpy(coords).requires_grad_()
        out = tcorr.lookup_corr_pyramid(list(zip(PYR_LEVELS, vs)), c, 4)
        out.backward(g)
        return [out.detach()] + [x.grad for x in vs + [c]]

    want = run()
    calls = {"fwd": [], "bwd": 0}

    def fake_fwd(levels, radius, out):
        calls["fwd"].append(len(levels))
        cw.corr_window_lookup_levels_plain(levels, radius, out)

    def fake_bwd(corr, cx, cy, radius, g, chan_off):
        calls["bwd"] += 1
        return cw.corr_window_lookup_bwd_plain(corr, cx, cy, radius, g,
                                               chan_off)

    monkeypatch.setattr(cw, "_is_cuda", lambda x: True)
    monkeypatch.setattr(cw, "_launch_levels", fake_fwd)
    monkeypatch.setattr(cw, "_launch_bwd", fake_bwd)
    fwd0 = cw.corr_window_lookup.launches
    bwd0 = cw.corr_window_lookup_bwd.launches
    got = run()
    assert calls == {"fwd": [3], "bwd": 3}
    assert cw.corr_window_lookup.launches == fwd0 + 1
    assert cw.corr_window_lookup_bwd.launches == bwd0 + 3
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_levels_match_plain_on_card(dtype):
    # All levels in one launch, against the plain per-level lookup: level
    # widths 64, 32, 10, 8 and 13 (rows at any 4-byte offset in f32, at odd
    # element offsets in bf16, whose aligned pairs then straddle rows),
    # with centres far outside and just outside the maps; f32 accumulation,
    # fused multiply-adds: atol 1e-5 at unit-scale values.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(6)
    tdt = getattr(torch, dtype)
    b, h1, w1 = 2, 6, 8
    q = h1 * w1
    shapes = [(3, 24, 64), (1, 12, 32), (1, 12, 10), (1, 6, 8), (1, 7, 13)]
    levels, off = [], 0
    for t, h2, w2 in shapes:
        corr = torch.randn(t, b, q, h2, w2, generator=gen).to(tdt)
        cx = torch.rand(t, b, q, generator=gen) * (w2 + 16) - 8
        cy = torch.rand(t, b, q, generator=gen) * (h2 + 16) - 8
        cx[0, 0, :3] = torch.tensor([1e12, -1e12, float(w2) - 0.5])
        cy[0, 1, :2] = torch.tensor([-1e9, h2 + 0.25])
        levels.append((corr.to(dev), cx.to(dev), cy.to(dev), off))
        off += t * 81
    out = torch.full((b, off, h1, w1), float("nan"), device=dev)
    before = cw.corr_window_lookup.launches
    cw.corr_window_lookup_levels(levels, 4, out)
    torch.cuda.synchronize()
    assert cw.corr_window_lookup.launches == before + 1
    want = cw.corr_window_lookup_levels_plain(
        levels, 4, torch.full_like(out, float("nan")))
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_levels_of_offset_views_match_plain_on_card(dtype):
    # Volumes that are contiguous views starting 1 and 3 elements into
    # their storage (a bf16 view then starts at an odd 2-byte word, so its
    # aligned pairs begin one value before the view), with windows on the
    # first and the last value of each volume, against the plain lookup.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(8)
    tdt = getattr(torch, dtype)
    b, h1, w1 = 2, 3, 5
    q = h1 * w1
    levels, off = [], 0
    for (t, h2, w2), start in zip([(2, 9, 13), (1, 6, 10), (1, 5, 7)],
                                  [1, 3, 1]):
        n = t * b * q * h2 * w2
        store = torch.randn(n + 4, generator=gen).to(tdt).to(dev)
        corr = store[start:start + n].view(t, b, q, h2, w2)
        assert corr.is_contiguous() and corr.storage_offset() == start
        cx = torch.rand(t, b, q, generator=gen) * (w2 + 8) - 4
        cy = torch.rand(t, b, q, generator=gen) * (h2 + 8) - 4
        cx[0, 0, 0], cy[0, 0, 0] = 0.25, 0.5              # the first value
        cx[-1, -1, -1], cy[-1, -1, -1] = w2 - 0.75, h2 - 0.5  # the last
        levels.append((corr, cx.to(dev), cy.to(dev), off))
        off += t * 81
    out = torch.full((b, off, h1, w1), float("nan"), device=dev)
    cw.corr_window_lookup_levels(levels, 4, out)
    torch.cuda.synchronize()
    want = cw.corr_window_lookup_levels_plain(
        levels, 4, torch.full_like(out, float("nan")))
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5)

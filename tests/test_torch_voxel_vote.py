"""Port's trilinear voxel vote (kernel row 8) and device voxelization vs the
JAX package.

The oracle is the JAX exact-f32 scatter voxelizer (ops/events.py::
voxel_grid_from_events) and `voxelize_batch_on_device` on its
`sorted_cell_size=None` path; the TPU kernel `voxel_vote_pallas_sorted`
runs in interpret mode with its bf16 tap tiles.  JAX runs on the CPU
(tests/conftest.py); inputs are numpy arrays from a seed.  On the CPU the
port's wrapper runs its plain version; the CUDA kernel is held against it
by the `cuda` test, on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_voxel_vote.py
"""

import numpy as np
import pytest
import torch

from motionpriorcmax_tpu_torch.ops import events as ev_ops
from motionpriorcmax_tpu_torch.ops.cuda import voxel_vote as vv

try:
    import jax
    import jax.numpy as jnp

    from motionpriorcmax_tpu.data.host_ops import lut_cell_sort
    from motionpriorcmax_tpu.ops.events import voxel_grid_from_events
    from motionpriorcmax_tpu.ops.pallas.voxel_vote import \
        voxel_vote_pallas_sorted
    from motionpriorcmax_tpu.training import trajectory_net as jtn
except ImportError:         # the GPU machine: only the cuda test runs there
    jax = None

H, W, NB, S = 32, 48, 5, 4


def make_events(seed, b=2, m=5000, sort=False):
    """Event rows with border taps (coordinates from -1.5 to size + 0.5),
    times at bin edges, far-out coordinates and invalid rows; sorted by LUT
    cell (the loader's order) when `sort`."""
    rng = np.random.default_rng(seed)
    y = rng.uniform(-1.5, H + 0.5, (b, m))
    x = rng.uniform(-1.5, W + 0.5, (b, m))
    t = rng.uniform(0, 1, (b, m))
    t[:, :40] = rng.integers(0, NB, (b, 40)) / (NB - 1)   # on bin edges
    t[:, 40:50] = 1.0
    y[:, 50:60] = np.round(y[:, 50:60])                   # integer taps
    x[:, 60:65] = 1e9
    y[:, 65:70] = -1e9
    p = rng.integers(0, 2, (b, m))
    bins = np.clip((t * NB).astype(np.int32), 0, NB - 1)
    valid = (rng.uniform(size=(b, m)) > 0.1).astype(np.float32)
    ev = np.stack([y, x, t, p, bins, valid], -1).astype(np.float32)
    if sort:
        ev = np.stack([lut_cell_sort(e, (H, W), NB, S)[0] for e in ev])
    return ev


def jax_exact(ev):
    return np.stack([np.asarray(voxel_grid_from_events(
        jnp.asarray(e[:, 0]), jnp.asarray(e[:, 1]),
        jnp.asarray(e[:, 2] * (NB - 1)), jnp.asarray(e[:, 3]),
        jnp.asarray(e[:, 5]), num_bins=NB, height=H, width=W)) for e in ev])


@pytest.mark.parametrize("sort", [True, False])
def test_plain_matches_jax_exact_vote(sort):
    # The same f32 tap weights; only the order in which one voxel's votes
    # are added differs (index_add_ vs XLA's scatter): 1e-5 of the largest
    # voxel.
    ev = make_events(0, sort=sort)
    want = jax_exact(ev)
    got = ev_ops.voxel_grid_from_events(torch.from_numpy(ev), num_bins=NB,
                                        height=H, width=W)
    assert got.shape == (2, NB, H, W) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # Far-out and invalid rows vote nothing.
    ev[:, 60:70, 5] = 0.0
    assert torch.equal(vv.voxel_vote(torch.from_numpy(ev), NB, H, W),
                       vv.voxel_vote_plain(torch.from_numpy(ev), NB, H, W))


@pytest.mark.parametrize("sort", [True, False])
def test_plain_matches_pallas_interpret(sort):
    # The TPU kernel rounds its tap weights to bf16 (8 mantissa bits):
    # within 1e-2 of the largest voxel.
    ev = make_events(1, sort=sort)
    want = np.asarray(jax.jit(lambda e: voxel_vote_pallas_sorted(
        e, num_bins=NB, height=H, width=W, cell_size=S, band=32,
        interpret=True))(jnp.asarray(ev)))
    got = vv.voxel_vote_plain(torch.from_numpy(ev), NB, H, W).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("norm_type,quantile", [
    ("mean_std", 0.0), ("max", 0.0), ("mean_std", 0.05), (None, 0.0)])
def test_voxelize_batch_on_device_matches_jax(norm_type, quantile):
    # The JAX sorted_cell_size=None path (exact scatter, then clamp and
    # normalize per sample): normalized values within 1e-5 of the largest
    # (1e-4 after the quantile clamp, whose threshold interpolates between
    # two order statistics in another f32 order).
    from motionpriorcmax_tpu_torch.training import trajectory_net as ttn

    ev = make_events(2, sort=True)
    ev[1, :, 5] = 0.0                      # an empty window stays zero
    kw = dict(image_shape=(H, W), num_bins=NB, voxel_norm_type=norm_type,
              voxel_quantile=quantile)
    want = np.asarray(jax.jit(lambda e: jtn.voxelize_batch_on_device(
        jtn.TrajectoryNetConfig(**kw), e))(jnp.asarray(ev)))
    got = ttn.voxelize_batch_on_device(ttn.TrajectoryNetConfig(**kw),
                                       torch.from_numpy(ev)).numpy()
    tol = 1e-4 if quantile > 0 else 1e-5
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())
    assert not got[1].any()


def test_quantile_clamp_refuses_oversized_grids():
    grid = torch.zeros(1, 65, 512, 512)
    with pytest.raises(ValueError, match="2\\^24"):
        ev_ops.clamp_voxel_grid_quantile(grid, 0.01)
    assert ev_ops.clamp_voxel_grid_quantile(grid, 0.0) is grid


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card, cell-sorted
    and unsorted events: within 1e-5 of the largest voxel, since the
    kernel adds a voxel's votes in another, run-dependent order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    b, m = 3, 30011
    ev = np.stack([rng.uniform(-1.5, H + 0.5, (b, m)),
                   rng.uniform(-1.5, W + 0.5, (b, m)),
                   rng.uniform(0, 1, (b, m)), rng.integers(0, 2, (b, m)),
                   np.zeros((b, m)), rng.uniform(size=(b, m)) > 0.1],
                  -1).astype(np.float32)
    ev[:, :10, 0] = 1e9
    ev[:, 10:20, 2] = 1.0
    order = np.lexsort((ev[..., 1] // S, ev[..., 0] // S), axis=-1)
    for events in (np.take_along_axis(ev, order[..., None], 1), ev):
        e = torch.from_numpy(np.ascontiguousarray(events)).cuda()
        before = vv.voxel_vote.launches
        got = vv.voxel_vote(e, NB, H, W)
        torch.cuda.synchronize()
        assert vv.voxel_vote.launches == before + 1
        want = vv.voxel_vote_plain(e, NB, H, W)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


# -- the kernel's tiling (csrc/voxel_vote.cu), through its plain twin ---------

def make_tile_events(seed, b=2, m=6000, ty=4, tx=8):
    """Events that probe the tiling at (ty, tx): on tile edges and corners
    (taps crossing into the next tile right, below or both), at -3, -1,
    size - 1 and size + 2, far out, padding (valid 0), a hot tile holding a
    third of the events and a hot pixel holding 5%."""
    rng = np.random.default_rng(seed)
    y = rng.uniform(-1.5, H + 0.5, (b, m))
    x = rng.uniform(-1.5, W + 0.5, (b, m))
    t = rng.uniform(0, 1, (b, m))
    fy, fx = rng.uniform(0, 1, (2, b, 400))
    y[:, :400] = rng.integers(1, H // ty, (b, 400)) * ty - fy * 0.5  # crossing
    x[:, 200:600] = rng.integers(1, W // tx, (b, 400)) * tx - fx * 0.5
    x[:, 600:640] = rng.choice([-3.0, -1.0, -0.5, W - 1.0, W - 0.5, W + 2.0],
                               (b, 40))
    y[:, 640:680] = rng.choice([-3.0, -1.0, -0.5, H - 1.0, H - 0.5, H + 2.0],
                               (b, 40))
    t[:, 680:720] = rng.choice([0.0, 1.0, 1.0 + 1e-6, -1e-3], (b, 40))
    x[:, 720:730] = 1e9
    y[:, 730:740] = -1e9
    y[:, 1000:3000] = rng.uniform(ty, 2 * ty, (b, 2000))           # hot tile
    x[:, 1000:3000] = rng.uniform(tx, 2 * tx, (b, 2000))
    y[:, 3000:3300] = ty + 1.25                                     # hot pixel
    x[:, 3000:3300] = 2 * tx - 0.75
    p = rng.integers(0, 2, (b, m))
    valid = (rng.uniform(size=(b, m)) > 0.1).astype(np.float32)
    ev = np.stack([y, x, t, p, np.zeros((b, m)), valid], -1).astype(np.float32)
    return ev


@pytest.mark.parametrize("ty,tx", [(4, 8), (3, 12), (16, 64)])
def test_tiling_keeps_each_in_range_tap_once(ty, tx):
    # Every tap of a voting event that lies inside the grid is kept by
    # exactly one of the tiles that read the event's record; no other tap
    # is kept by any tile.
    ev = torch.from_numpy(make_tile_events(3))
    keeps = vv.voxel_tile_keeps(ev, NB, H, W, ty, tx)          # [4, 8, B, M]
    _, _, in_range = vv.voxel_tap_in_range(ev, NB, H, W)
    assert torch.equal(keeps.sum(0), in_range.long())
    # The edge events do cross tiles, so the neighbours' reads are exercised.
    readers = vv.voxel_tile_readers(ev, NB, H, W, ty, tx)
    if (ty, tx) != (16, 64):
        assert all((readers[r] >= 0).any() for r in range(4))
    live, _, _ = vv.voxel_event_tiles(ev, NB, H, W, ty, tx)
    assert torch.equal(readers[0] >= 0, live)


@pytest.mark.parametrize("ty,tx", [(4, 8), (16, 64)])
def test_tiled_sum_matches_plain_and_jax(ty, tx):
    # The tiles' sums, tile by tile, give the plain vote (up to the order of
    # a voxel's f32 adds) and the JAX exact voxelizer: 1e-5 of the largest
    # voxel.
    ev = make_tile_events(4, ty=4, tx=8)
    want = jax_exact(ev)
    evt = torch.from_numpy(ev)
    got = vv.voxel_vote_tiled_plain(evt, NB, H, W, ty, tx)
    plain = vv.voxel_vote_plain(evt, NB, H, W)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=1e-5 * scale)
    pad = evt.clone()
    pad[..., 5] = 0.0                        # all padding: an all-zero grid
    assert not vv.voxel_vote_tiled_plain(pad, NB, H, W, ty, tx).any()


def test_tile_shape_fits_shared_memory():
    assert vv.voxel_tile_shape(15, 480, 640) == (16, 64)
    for nbins in (1, 5, 15, 41, 65, 300, 3840):
        ty, tx = vv.voxel_tile_shape(nbins, 480, 640)
        assert tx % 4 == 0 and ty >= 1
        assert nbins * ty * tx <= vv.MAX_TILE_FLOATS
    with pytest.raises(ValueError, match="bins"):
        vv.voxel_tile_shape(4000, 480, 640)


def _card_events(rng, b, m, h, w, skew=False):
    ev = np.stack([rng.uniform(-3.5, h + 2.5, (b, m)),
                   rng.uniform(-3.5, w + 2.5, (b, m)),
                   rng.uniform(0, 1, (b, m)), rng.integers(0, 2, (b, m)),
                   np.zeros((b, m)), rng.uniform(size=(b, m)) > 0.1],
                  -1).astype(np.float32)
    ev[:, :64, 0] = rng.integers(0, h // 16 + 1, (b, 64)) * 16 - 0.5
    ev[:, 32:96, 1] = rng.integers(0, w // 64 + 1, (b, 64)) * 64 - 0.25
    if skew:                 # half in one 16 x 64 tile, 1% on one pixel
        k = m // 2
        ev[:, 100:100 + k, 0] = rng.uniform(16, 32, (b, k))
        ev[:, 100:100 + k, 1] = rng.uniform(64, 128, (b, k))
        ev[:, 100:100 + m // 100, 0] = 20.5
        ev[:, 100:100 + m // 100, 1] = 70.25
    return ev


CARD_H, CARD_W, CARD_NB = 40, 200, 5


def _card_case(case):
    rng = np.random.default_rng(7)
    b, m = {"uniform": (3, 30011), "skewed": (2, 140000),
            "padding": (2, 9000), "ragged": (1, 12345)}[case]
    ev = _card_events(rng, b, m, CARD_H, CARD_W, skew=case == "skewed")
    if case == "padding":
        ev[..., 5] = 0.0
    return ev


def _hot_records():
    """kHotRecords of the source: the records a tile reads at which its
    cluster shares the work."""
    import re

    from motionpriorcmax_tpu_torch.ops.cuda.build import CSRC_DIR

    src = (CSRC_DIR / "voxel_vote.cu").read_text()
    return int(re.search(r"constexpr int kHotRecords = (\d+);", src).group(1))


def test_skewed_card_case_has_hot_tiles():
    # The card test's skewed batch must take the cluster-shared path: in
    # each sample one tile reads at least 1.5x the threshold's records
    # (counted by the tiling's plain twin), and the uniform batch none.
    ty, tx = vv.voxel_tile_shape(CARD_NB, CARD_H, CARD_W)
    hot = _hot_records()
    for case, want_hot in (("skewed", True), ("uniform", False)):
        ev = torch.from_numpy(_card_case(case))
        readers = vv.voxel_tile_readers(ev, CARD_NB, CARD_H, CARD_W, ty, tx)
        tiles = -(-CARD_H // ty) * -(-CARD_W // tx)
        for i in range(ev.shape[0]):
            r = readers[:, i].reshape(-1)
            reads = torch.bincount(r[r >= 0], minlength=tiles)
            if want_hot:
                assert int(reads.max()) >= 1.5 * hot, (case, i, int(reads.max()))
            else:
                assert int(reads.max()) < hot, (case, i, int(reads.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "skewed", "padding", "ragged"])
def test_tiled_kernel_matches_plain_on_card(case):
    """The tiled kernel against its plain version: uniform events, a
    skewed batch whose hot tile reads at least 1.5x the cluster-split
    threshold (kHotRecords, test_skewed_card_case_has_hot_tiles), all
    padding (the grid is written whole: zeros), and B = 1 with a ragged
    M; within 1e-5 of the largest voxel (a voxel's votes are added in the
    order of the sorted records, which depends on the run)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    h, w, nb = CARD_H, CARD_W, CARD_NB
    e = torch.from_numpy(_card_case(case)).cuda()
    before = vv.voxel_vote.launches
    got = vv.voxel_vote(e, nb, h, w)
    torch.cuda.synchronize()
    assert vv.voxel_vote.launches == before + 1
    want = vv.voxel_vote_plain(e, nb, h, w)
    if case == "padding":
        assert not got.any()
    else:
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))

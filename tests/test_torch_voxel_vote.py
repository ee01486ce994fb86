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
    atomics add a voxel's votes in another order on every run."""
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

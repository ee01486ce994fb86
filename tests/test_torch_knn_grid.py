"""The port's windowed and batched KNN, knn_method approx / grid /
grid_approx and the L1 softmax interpolation vs the JAX package, on the
CPU.

Points are jittered so that no two candidates tie (`lax.top_k` and
`torch.topk` break ties differently).  JAX's `lax.approx_min_k` is exact
off the TPU; the first test shows it on the CPU, which is why the port's
'approx' is the exact top-k.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from motionpriorcmax_tpu.losses import FocusLossConfig as JaxFocusCfg
from motionpriorcmax_tpu.losses import focus_loss as jax_focus_loss
from motionpriorcmax_tpu.losses.focus import _lut_grid_points
from motionpriorcmax_tpu.losses.focus import (
    _softmax_interpolate_flow as jax_softmax_flow)
from motionpriorcmax_tpu.ops import knn as jknn
from motionpriorcmax_tpu_torch.losses import FocusLossConfig, focus_loss
from motionpriorcmax_tpu_torch.losses.focus import softmax_interp_l1
from motionpriorcmax_tpu_torch.ops import knn as tknn
from tests.test_torch_focus_loss import H, NB, W, make_batch, make_trajectories
from tests._one_thread import one_torch_thread  # noqa: F401

GH, GW, CELL = 12, 16, 4.0


def grid_queries():
    ys = np.arange(GH) * CELL + 1.5
    xs = np.arange(GW) * CELL + 1.5
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([gy.ravel(), gx.ravel()], -1).astype(np.float32)


def test_jax_approx_min_k_is_exact_on_cpu():
    # The reason the port's 'approx' computes the exact top-k.
    x = jnp.asarray(np.random.default_rng(0).normal(size=(64, 3000)),
                    jnp.float32)
    vals, idx = jax.lax.approx_min_k(x, 32)
    neg, want = jax.lax.top_k(-x, 32)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(vals), -np.asarray(neg))


@pytest.mark.parametrize("norm", ["l2", "l1"])
@pytest.mark.parametrize("method", ["exact", "approx"])
def test_knn_grid_window_matches_jax(norm, method):
    # Three databases of jittered points around the cell centres; in the
    # first, 40 points in one cell (capacity 4: the overflow is dropped,
    # the same entries as JAX's).  Radius 2: queries near the border and
    # near the crowded cell have fewer than K candidates, whose slots are
    # +inf with index 0.  Indices equal, distances to 1e-5 px^2.
    rng = np.random.default_rng(0)
    q = grid_queries()
    db = (q[None] + rng.normal(0, 6, (3, len(q), 2))).astype(np.float32)
    db[0, :40] = np.array([20.3, 30.1]) + rng.normal(0, 0.5, (40, 2))
    kw = dict(norm=norm, cell_size=CELL, grid_hw=(GH, GW), window_radius=2,
              cell_capacity=4, method=method)
    j_idx, j_dist = jax.vmap(lambda d: jknn.knn_grid_window(
        jnp.asarray(q), d, 32, **kw))(jnp.asarray(db))
    t_idx, t_dist = tknn.knn_grid_window(torch.from_numpy(q),
                                         torch.from_numpy(db), 32, **kw)
    j_idx, j_dist = np.asarray(j_idx), np.asarray(j_dist)
    empty = np.isinf(j_dist)
    assert 0.1 < empty.mean() < 0.9
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)
    np.testing.assert_array_equal(np.isinf(t_dist.numpy()), empty)
    assert (t_idx.numpy()[empty] == 0).all()
    np.testing.assert_allclose(t_dist.numpy()[~empty], j_dist[~empty],
                               rtol=0, atol=1e-5)
    # The crowded cell keeps its first 4 points in index order.
    table = tknn.grid_cell_table(torch.from_numpy(db), CELL, (GH, GW), 4)
    cell = np.floor(db[0] / CELL).astype(int)
    inside = np.flatnonzero((cell[:, 0] == 5) & (cell[:, 1] == 7))
    assert len(inside) > 4
    np.testing.assert_array_equal(table[0, 5, 7].numpy(), inside[:4])


@pytest.mark.parametrize("method", ["exact", "approx"])
def test_knn_batched_and_approx_match_jax(method):
    # Per-batch queries [2, 3, 50, 2] against databases [2, 3, 70, 2];
    # squared-l2 distances refined by direct subtraction on both sides.
    rng = np.random.default_rng(1)
    q = rng.normal(0, 10, (2, 3, 50, 2)).astype(np.float32)
    db = rng.normal(0, 10, (2, 3, 70, 2)).astype(np.float32)
    j_idx, j_dist = jknn.knn_batched(jnp.asarray(q), jnp.asarray(db), 8,
                                     method=method)
    t_idx, t_dist = tknn.knn_batched(torch.from_numpy(q),
                                     torch.from_numpy(db), 8, method=method)
    assert t_idx.shape == (2, 3, 50, 8)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_dist.numpy(), np.asarray(j_dist), rtol=0,
                               atol=1e-4)
    j_idx, j_dist = jknn.knn_blocked(jnp.asarray(q[0, 0]), jnp.asarray(db[0, 0]),
                                     8, norm="l1", method=method)
    t_idx, t_dist = tknn.knn_blocked(torch.from_numpy(q[0, 0]),
                                     torch.from_numpy(db[0, :1]), 8,
                                     norm="l1", method=method)
    np.testing.assert_array_equal(t_idx[0].numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_dist[0].numpy(), np.asarray(j_dist),
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="knn method"):
        tknn.knn_blocked(torch.from_numpy(q[0, 0]),
                         torch.from_numpy(db[0, :1]), 8, method="keops")


@pytest.mark.parametrize("variant", [
    {"knn_method": "grid", "num_knn": 128},
    {"knn_method": "grid_approx", "num_knn": 128,
     "interpolation_scheme": "iwd"},
    {"knn_method": "grid", "num_knn": 8, "dist_norm": "l1",
     "smooth_type": "on_flow_to_next"},
    {"knn_method": "approx", "num_knn": 8},
    {"knn_method": "softmax", "dist_norm": "l1", "knn_block_size": 40},
    {"knn_method": "softmax", "dist_norm": "l1", "knn_block_size": 1024,
     "smooth_type": "on_flow_to_next", "softmax_temp": 9.0},
])
def test_focus_loss_and_grad_match_jax(variant):
    # The focus loss and its gradient on the trajectories against JAX's.
    # K = 128 > N = 96 leaves every query's window with +inf slots, which
    # the mean and the inverse-distance weights skip.  The L1 softmax: JAX
    # rounds the exponent to bf16 and (XLA's excess precision) keeps the
    # exp in f32, as the port does: measured 1e-6.  Loss rtol 1e-5,
    # gradient atol 1e-4 of its largest entry, as the exact path's test.
    batch = make_batch(0)
    npos = batch["num_pos_events"]
    times = np.concatenate([[0.37], (np.arange(NB) + 0.5) / NB]).astype(
        np.float32)
    traj = make_trajectories(1, 2, times)
    kw = dict(image_shape=(H, W), num_bins=NB, **variant)
    jcfg, tcfg = JaxFocusCfg(**kw), FocusLossConfig(**kw)

    @jax.jit
    @jax.value_and_grad
    def jloss(t):
        return jax_focus_loss(jcfg, t, jnp.asarray(times),
                              jnp.asarray(batch["events"]), npos,
                              jnp.asarray(batch["lut_cell_ends"]))[0]

    l_j, g_j = jloss(jnp.asarray(traj))
    t = torch.from_numpy(traj).requires_grad_()
    l_t = focus_loss(tcfg, t, torch.from_numpy(times),
                     torch.from_numpy(batch["events"]), npos,
                     torch.from_numpy(batch["lut_cell_ends"]))[0]
    l_t.backward()
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=1e-5)
    g_j = np.asarray(g_j)
    assert np.abs(g_j).max() > 0
    np.testing.assert_allclose(t.grad.numpy(), g_j, rtol=0,
                               atol=1e-4 * np.abs(g_j).max())


def test_softmax_l1_interpolation_matches_jax():
    # The interpolation alone, output and both trajectory gradients: 1e-5
    # of the largest value (measured ~3e-7 relative).
    rng = np.random.default_rng(4)
    cfg = JaxFocusCfg(image_shape=(H, W), num_bins=3, knn_method="softmax",
                      dist_norm="l1", knn_block_size=40)
    hq, wq = H // 4, W // 4
    mid = (rng.uniform(0, 1, (2, 3, 96, 2)) * [H, W]).astype(np.float32)
    ref = (mid[:, :1] + rng.normal(0, 1, (2, 1, 96, 2))).astype(np.float32)
    gp = _lut_grid_points(cfg)

    def jflow(a, b):
        return jax_softmax_flow(cfg, jnp.asarray(gp), a, b, hq, wq)[0]

    want = np.asarray(jax.jit(jflow)(jnp.asarray(ref), jnp.asarray(mid)))
    g_out = rng.normal(size=want.shape).astype(np.float32)
    g_ref, g_mid = jax.jit(jax.grad(lambda a, b: jnp.sum(jflow(a, b) * g_out),
                                    argnums=(0, 1)))(jnp.asarray(ref),
                                                     jnp.asarray(mid))
    from motionpriorcmax_tpu_torch.losses.focus import (
        _softmax_interpolate_flow as port_flow)

    tcfg = FocusLossConfig(image_shape=(H, W), num_bins=3,
                           knn_method="softmax", dist_norm="l1",
                           knn_block_size=40)
    a = torch.from_numpy(ref).requires_grad_()
    b = torch.from_numpy(mid).requires_grad_()
    got = port_flow(tcfg, torch.from_numpy(gp), a, b, hq, wq)[0]
    (got * torch.from_numpy(g_out)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    for mine, theirs in ((a.grad, g_ref), (b.grad, g_mid)):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(mine.numpy(), theirs, rtol=0,
                                   atol=1e-5 * np.abs(theirs).max())
    # Blocks of other sizes give the same values.
    db = torch.from_numpy(mid.reshape(6, 96, 2))
    vals = torch.from_numpy(rng.normal(size=(6, 96, 3)).astype(np.float32))
    one = softmax_interp_l1(torch.from_numpy(gp), db, vals, 25.0, 1024)
    many = softmax_interp_l1(torch.from_numpy(gp), db, vals, 25.0, 7)
    np.testing.assert_allclose(many.numpy(), one.numpy(), rtol=1e-6,
                               atol=1e-6)

"""Port's focus loss and the ops under it vs the JAX package, on the CPU.

Same numpy inputs to both sides.  The JAX focus loss runs its CPU path,
which is the exact-f32 function the port's kernels compute: the 'direct'
vote, the 'xla' LUT gather and the 'sorted' cumsum backward over cell_ends.
Trajectories are jittered so that no two neighbours tie at the K-th
distance (`lax.top_k` and `torch.topk` break ties differently).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from motionpriorcmax_tpu.config.core import propagate_config as jax_propagate
from motionpriorcmax_tpu.data.collate import (
    collate_fixed_capacity as jax_collate)
from motionpriorcmax_tpu.data.host_ops import lut_cell_sort as jax_cell_sort
from motionpriorcmax_tpu.data.host_ops import (
    voxelize_normalized_host as jax_voxelize)
from motionpriorcmax_tpu.losses import FocusLossConfig as JaxFocusCfg
from motionpriorcmax_tpu.losses import focus_loss as jax_focus_loss
from motionpriorcmax_tpu.ops import events as jev
from motionpriorcmax_tpu.ops import gradients as jgrad
from motionpriorcmax_tpu.ops.grids import interpolate_dense_flow as jax_interp
from motionpriorcmax_tpu.ops.knn import knn_blocked as jax_knn
from motionpriorcmax_tpu_torch.config import propagate_config
from motionpriorcmax_tpu_torch.data.collate import collate_fixed_capacity
from motionpriorcmax_tpu_torch.data.host_ops import (lut_cell_sort,
                                                     voxelize_normalized_host)
from motionpriorcmax_tpu_torch.losses import FocusLossConfig, focus_loss
from motionpriorcmax_tpu_torch.ops import events as tev
from motionpriorcmax_tpu_torch.ops import gradients as tgrad
from motionpriorcmax_tpu_torch.ops.grids import interpolate_dense_flow
from motionpriorcmax_tpu_torch.ops.knn import knn_blocked

H, W, S, NB = 32, 48, 4, 15


def make_events(rng, n, h=H, w=W, nb=NB):
    """[n, 5] (y, x, t, p, bin) rows like the DSEC loader's."""
    t = np.sort(rng.uniform(0, 1, n))
    ev = np.stack([rng.integers(0, h, n), rng.integers(0, w, n), t,
                   rng.integers(0, 2, n),
                   np.clip(np.searchsorted(np.linspace(0, 1, nb + 1), t) - 1,
                           0, None)], -1)
    return ev.astype(np.float32)


def make_batch(seed, b=2, capacity=1024, n=700):
    """Polarity-packed, cell-sorted events through the JAX collate."""
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(b):
        ev = make_events(rng, n)
        samples.append({"pos_events": ev[ev[:, 3] == 1],
                        "neg_events": ev[ev[:, 3] == 0]})
    return jax_collate(samples, capacity, polarity_aware=True,
                       lut_cell_sort_params=((H, W), NB, S))


def make_trajectories(seed, b, times, patch=4):
    """Grid offsets plus a jittered linear motion, [B, T, N, 2] f32."""
    rng = np.random.default_rng(seed)
    ys = np.arange(patch // 2, H, patch)
    xs = np.arange(patch // 2, W, patch)
    off = np.stack(np.meshgrid(ys, xs, indexing="ij"), -1).reshape(-1, 2)
    c = rng.normal(0, 3, (b, off.shape[0], 2))
    off = off + rng.uniform(-0.3, 0.3, off.shape)
    traj = off[None, None] + np.asarray(times)[None, :, None, None] * c[:, None]
    return traj.astype(np.float32)


@pytest.mark.parametrize("variant", [
    {},                                                    # dsec.yaml
    {"interpolation_scheme": "iwd", "smooth_type": "on_flow_to_next"},
    {"polarity_aware_batching": False, "loss_type": "variance",
     "focus_loss_norm": "l2", "scale_iwe_by_dt": False},
])
def test_focus_loss_and_grad_match_jax(variant):
    # Loss rtol 1e-5: the votes of a pixel add in another order and the
    # blur / Sobel / mean reductions round differently (f32).  Gradient
    # atol 1e-4 of its largest entry: the LUT backward sums the same
    # cotangents per cell (JAX by cumsum differences).
    batch = make_batch(0)
    npos = batch["num_pos_events"]
    if not variant.get("polarity_aware_batching", True):
        npos = -1
    times = np.concatenate([[0.37], (np.arange(NB) + 0.5) / NB]).astype(
        np.float32)
    traj = make_trajectories(1, 2, times)
    kw = dict(image_shape=(H, W), num_bins=NB, num_knn=8, **variant)
    jcfg, tcfg = JaxFocusCfg(**kw), FocusLossConfig(**kw)

    @jax.jit
    @jax.value_and_grad
    def jloss(t):
        return jax_focus_loss(jcfg, t, jnp.asarray(times),
                              jnp.asarray(batch["events"]), npos,
                              jnp.asarray(batch["lut_cell_ends"]))[0]

    l_j, g_j = jloss(jnp.asarray(traj))
    t = torch.from_numpy(traj).requires_grad_()
    l_t, logs, misc = focus_loss(tcfg, t, torch.from_numpy(times),
                                 torch.from_numpy(batch["events"]), npos,
                                 torch.from_numpy(batch["lut_cell_ends"]))
    l_t.backward()
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=1e-5)
    g_j = np.asarray(g_j)
    assert np.abs(g_j).max() > 0
    np.testing.assert_allclose(t.grad.numpy(), g_j, rtol=0,
                               atol=1e-4 * np.abs(g_j).max())
    planes = (2,) if tcfg.polarity_aware_batching else ()
    assert misc["iwes"].shape == (2, 1, *planes, H, W)
    assert set(logs) == {"focus_loss", "smoothness_loss"}


def test_unsorted_warp_matches_sorted():
    # Without cell_ends the warp takes plain indexing (JAX 'native'): the
    # same loss and gradient as the sorted kernel path.
    batch = make_batch(2)
    npos = batch["num_pos_events"]
    times = np.concatenate([[0.8], (np.arange(NB) + 0.5) / NB]).astype(
        np.float32)
    traj = make_trajectories(3, 2, times)
    cfg = FocusLossConfig(image_shape=(H, W), num_bins=NB, num_knn=8)
    grads = []
    for ends in (torch.from_numpy(batch["lut_cell_ends"]), None):
        t = torch.from_numpy(traj).requires_grad_()
        loss = focus_loss(cfg, t, torch.from_numpy(times),
                          torch.from_numpy(batch["events"]), npos, ends)[0]
        loss.backward()
        grads.append((float(loss.detach()), t.grad))
    assert grads[0][0] == pytest.approx(grads[1][0], rel=1e-6)
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=1e-5, atol=1e-7)


def test_knn_matches_jax():
    # Same neighbours in the same order (no ties), squared distances
    # refined by direct subtraction as in JAX: rtol 1e-6.
    rng = np.random.default_rng(4)
    q = rng.uniform(0, 60, (150, 2)).astype(np.float32)
    db = rng.uniform(0, 60, (3, 97, 2)).astype(np.float32)
    idx, dist = knn_blocked(torch.from_numpy(q), torch.from_numpy(db), 16)
    for i in range(3):
        ji, jd = jax_knn(jnp.asarray(q), jnp.asarray(db[i]), 16,
                         block_size=64)
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(ji))
        np.testing.assert_allclose(dist[i].numpy(), np.asarray(jd), rtol=1e-6)


def test_stencils_match_jax():
    # Sobel (zero padding), blur (reflect padding), focus objective and
    # smoothness: the same shifted adds, atol 1e-5 / rtol 1e-6.
    img = np.random.default_rng(5).normal(size=(3, 2, 11, 13)).astype(
        np.float32)
    for a, b in zip(tgrad.sobel_gradients(torch.from_numpy(img)),
                    jgrad.sobel_gradients(jnp.asarray(img))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    np.testing.assert_allclose(
        tev.gaussian_blur_3x3(torch.from_numpy(img)).numpy(),
        np.asarray(jev.gaussian_blur_3x3(jnp.asarray(img))), atol=1e-6)
    for norm in ("l1", "l2"):
        for lt in ("gradient_magnitude", "variance"):
            np.testing.assert_allclose(
                float(tgrad.focus_objective(torch.from_numpy(img), lt, norm)),
                float(jgrad.focus_objective(jnp.asarray(img), lt, norm)),
                rtol=1e-6)
    np.testing.assert_allclose(
        float(tgrad.smoothness_loss(torch.from_numpy(img[:, :2]))),
        float(jgrad.smoothness_loss(jnp.asarray(img[:, :2]))), rtol=1e-6)


def test_dense_flow_upsample_matches_jax_cubic():
    # jax.image.resize 'cubic' (Keys a = -0.5, edge renormalization), which
    # differs from torch's bicubic (a = -0.75, clamped): atol 1e-5.
    flow = np.random.default_rng(6).normal(size=(2, 2, 8, 12)).astype(
        np.float32)
    got = interpolate_dense_flow(torch.from_numpy(flow), (32, 48)).numpy()
    want = np.asarray(jax_interp(jnp.asarray(flow), (32, 48)))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("npos", [-1, 300])
def test_cell_sort_and_collate_identical_to_jax(npos):
    rng = np.random.default_rng(7)
    ev = np.zeros((700, 6), np.float32)
    ev[:650, :5] = make_events(rng, 650)
    ev[:650, 5] = 1.0
    ev[:40, :2] += rng.uniform(0, 1, (40, 2)).astype(np.float32)
    a = lut_cell_sort(ev, (H, W), NB, S, num_pos_events=npos)
    b = jax_cell_sort(ev, (H, W), NB, S, num_pos_events=npos)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[1].dtype == np.int32

    samples = [{"pos_events": make_events(rng, 300),
                "neg_events": make_events(rng, 500),
                "voxel": rng.normal(size=(NB, H, W)).astype(np.float32)}
               for _ in range(2)]
    args = (samples, 1024, True)
    kw = dict(lut_cell_sort_params=((H, W), NB, S))
    got, want = collate_fixed_capacity(*args, **kw), jax_collate(*args, **kw)
    assert got.keys() == want.keys() and got["num_pos_events"] == 512
    for key in ("events", "lut_cell_ends", "voxel"):
        np.testing.assert_array_equal(got[key], want[key])


def test_host_voxelize_matches_jax():
    # np.bincount in place of np.add.at: the same f64 sums, cast to f32.
    ev = make_events(np.random.default_rng(8), 4000)
    ev[:, :2] += np.random.default_rng(9).uniform(0, 1, (4000, 2))
    got = voxelize_normalized_host(ev, NB, H, W)
    want = jax_voxelize(ev, NB, H, W)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_config_propagation_and_unported_knn():
    import copy

    import yaml

    with open("config/flow_training/dsec.yaml") as fh:
        raw = yaml.safe_load(fh)
    assert propagate_config(copy.deepcopy(raw)) == jax_propagate(
        copy.deepcopy(raw))
    for method in ("approx", "grid", "grid_approx"):
        with pytest.raises(NotImplementedError):
            FocusLossConfig(knn_method=method)
    # The softmax interpolation is ported for the l2 distance only.
    FocusLossConfig(knn_method="softmax")
    with pytest.raises(NotImplementedError, match="l2 only"):
        FocusLossConfig(knn_method="softmax", dist_norm="l1")

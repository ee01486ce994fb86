"""Port's self-supervised flow step on unsorted events (a batch collated
without the LUT-cell sort, so without 'lut_cell_ends': the DataLoader's
default) vs the JAX package's train step on the same batch, on the CPU.

The LUT gather's backward is then the any-order segment sum (kernel row 5;
JAX 'native' scatter on the CPU) and the IWE vote runs on events in any
order (row 4).  Exact KNN with the host voxel grid, and the softmax
interpolation (JAX's Pallas branch in interpret mode) with the voxel grid
built in the step, as tests/test_torch_flow_train{,_softmax}.py run them.
Both sides run on the same weights, with the JAX UNet narrowed as there.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import motionpriorcmax_tpu.training.trajectory_net as jtn
from motionpriorcmax_tpu.losses import FocusLossConfig as JaxFocusCfg
from motionpriorcmax_tpu.losses import get_reconstruction_times as jax_times
from motionpriorcmax_tpu_torch.data.collate import collate_fixed_capacity
from motionpriorcmax_tpu_torch.data.host_ops import voxelize_normalized_host
from motionpriorcmax_tpu_torch.losses import FocusLossConfig
from motionpriorcmax_tpu_torch.ops.cuda import segment_sum as ss
from motionpriorcmax_tpu_torch.training import trajectory_net as ttn
from motionpriorcmax_tpu_torch.training.checkpoint import flax_unet_to_torch
from motionpriorcmax_tpu_torch.training.loop import to_device
from tests.test_torch_flow_train import (H, LOSS_KW, NB, W, WIDTHS, configs,
                                         jax_state, make_events, port_state)
from tests._one_thread import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def jstate():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtn, "UNet", functools.partial(jtn.UNet, widths=WIDTHS))
        yield jax_state(configs()[0])


def unsorted_batch(seed, b=2, capacity=4096, n=2500):
    """Polarity-packed, host-voxelized, NOT cell-sorted (numpy)."""
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(b):
        ev = make_events(rng, n)
        samples.append({"pos_events": ev[ev[:, 3] == 1],
                        "neg_events": ev[ev[:, 3] == 0],
                        "voxel": voxelize_normalized_host(ev, NB, H, W)})
    return collate_fixed_capacity(samples, capacity, True)


@pytest.mark.parametrize("knn_method", ["exact", "softmax"])
def test_unsorted_train_step_matches_jax(jstate, knn_method):
    """Loss within 1e-4 relative; every gradient and BatchNorm statistic
    within 1e-4 of its tensor's largest value (f32 UNet convolutions and
    scatters that sum in another order)."""
    jcfg, tcfg = configs()
    kw = dict(LOSS_KW, knn_method=knn_method)
    jloss = JaxFocusCfg(use_pallas_interp=True, **kw)
    tloss = FocusLossConfig(**kw)
    batch = unsorted_batch(31 if knn_method == "exact" else 32)
    assert "lut_cell_ends" not in batch
    npos = batch["num_pos_events"]
    rng = jax.random.PRNGKey(7)
    jbatch = {"events": jnp.asarray(batch["events"])}
    if knn_method == "exact":
        jbatch["voxel"] = jnp.asarray(batch["voxel"])
        pbatch = batch
    else:
        # The step votes the voxel grid from the events on both sides.
        jbatch["voxel"] = jax.jit(functools.partial(
            jtn.voxelize_batch_on_device, jcfg))(jbatch["events"])
        pbatch = {k: v for k, v in batch.items() if k != "voxel"}

    @jax.jit
    def loss_fn(params):
        loss, (_, _, new_bs, _) = jtn._step(
            jcfg, jloss, params, jstate.batch_stats, jbatch, rng, train=True,
            num_pos_events=npos)
        return loss, new_bs

    (jloss_val, new_bs), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(jstate.params)

    state = port_state(tcfg, jstate)
    times = torch.tensor(np.asarray(jax_times(jloss, rng)))
    before = ss.grid_segment_sum.launches
    logs = ttn.train_step(state, to_device(pbatch, torch.device("cpu")), None,
                          tcfg, tloss, npos, times=times)
    assert ss.grid_segment_sum.launches == before    # CPU: plain version
    np.testing.assert_allclose(float(logs["train_losses/total"]),
                               float(jloss_val), rtol=1e-4)

    gsd = flax_unet_to_torch(grads["unet"], new_bs["unet"])
    ours = dict(state.model.unet.named_parameters())
    stats = state.model.unet.state_dict()
    for k, want in gsd.items():
        want = want.numpy()
        if k.endswith(("running_mean", "running_var")):
            got = stats[k].numpy()
        elif k.endswith("num_batches_tracked"):
            continue
        else:
            got = ours[k].grad.numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)


def test_unsorted_and_sorted_losses_agree(jstate):
    # The same events with and without the LUT-cell sort: the loss differs
    # only by summation order, and the LUT gradient reaches the same UNet
    # gradients.
    _, tcfg = configs()
    tloss = FocusLossConfig(**LOSS_KW)
    batch = unsorted_batch(33)
    sorted_batch = collate_fixed_capacity(
        [{"pos_events": e[:2048][e[:2048, 5] > 0][:, :5],
          "neg_events": e[2048:][e[2048:, 5] > 0][:, :5], "voxel": v}
         for e, v in zip(batch["events"], batch["voxel"])], 4096, True,
        lut_cell_sort_params=((H, W), NB, 4))
    times = torch.tensor([0.4] + [(i + 0.5) / NB for i in range(NB)])
    out = []
    for b in (batch, sorted_batch):
        state = port_state(tcfg, jstate)
        logs = ttn.train_step(state, to_device(b, torch.device("cpu")), None,
                              tcfg, tloss, b["num_pos_events"], times=times)
        out.append((float(logs["train_losses/total"]),
                    {k: p.grad.clone() for k, p in
                     state.model.unet.named_parameters()}))
    (l_u, g_u), (l_s, g_s) = out
    np.testing.assert_allclose(l_u, l_s, rtol=1e-5)
    for k in g_u:
        torch.testing.assert_close(g_u[k], g_s[k], rtol=0,
                                   atol=1e-4 * float(g_s[k].abs().max()))

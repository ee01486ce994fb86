"""Port's flow-training slice with knn_method='softmax' and on-device
voxelization vs the JAX package, on the CPU: one f32 train step (loss,
gradients, BatchNorm statistics), eval_step's EPE, a 2-step train_flow and
the flow-train CLI with --device-voxelize.

The JAX side runs its Pallas softmax branch (`use_pallas_interp=True`, in
interpret mode on the CPU) on a batch whose 'voxel' is its own exact device
voxel grid (`voxelize_batch_on_device` with sorted_cell_size=None); the
port's batch carries no 'voxel', so its step voxelizes the events itself.
Both sides run on the same weights (`flax_unet_to_torch`), with the JAX
UNet narrowed as in tests/test_torch_flow_train.py.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

import motionpriorcmax_tpu.training.trajectory_net as jtn
from motionpriorcmax_tpu.losses import FocusLossConfig as JaxFocusCfg
from motionpriorcmax_tpu.losses import get_reconstruction_times as jax_times
from motionpriorcmax_tpu_torch.losses import FocusLossConfig
from motionpriorcmax_tpu_torch.training import trajectory_net as ttn
from motionpriorcmax_tpu_torch.training.checkpoint import flax_unet_to_torch
from motionpriorcmax_tpu_torch.training.loop import to_device, train_flow
from tests.test_data_dsec import make_synthetic_dsec_sequence
from tests.test_torch_flow_train import (H, LOSS_KW, NB, W, WIDTHS, configs,
                                         jax_state, make_batch,
                                         make_val_sequence, port_state)
from tests._one_thread import one_torch_thread  # noqa: F401

SOFTMAX_KW = dict(LOSS_KW, knn_method="softmax")


@pytest.fixture(scope="module")
def jstate():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtn, "UNet", functools.partial(jtn.UNet, widths=WIDTHS))
        yield jax_state(configs()[0])


def loss_configs():
    return (JaxFocusCfg(use_pallas_interp=True, **SOFTMAX_KW),
            FocusLossConfig(**SOFTMAX_KW))


def split_batch(jcfg, batch, keys=("events", "lut_cell_ends")):
    """(JAX batch with its exact device voxel grid, port batch without a
    voxel)."""
    jbatch = {k: jnp.asarray(batch[k]) for k in keys}
    jbatch["voxel"] = jax.jit(functools.partial(
        jtn.voxelize_batch_on_device, jcfg))(jbatch["events"])
    port = {k: v for k, v in batch.items() if k != "voxel"}
    return jbatch, port


def test_train_step_softmax_device_voxel_matches_jax(jstate):
    """Loss within 1e-4 relative; every gradient and BatchNorm statistic
    within 1e-4 of its tensor's largest value (f32 UNet convolutions and
    sums in another order)."""
    jcfg, tcfg = configs()
    jloss, tloss = loss_configs()
    batch = make_batch(3)
    npos = batch["num_pos_events"]
    rng = jax.random.PRNGKey(5)
    jbatch, pbatch = split_batch(jcfg, batch)

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
    logs = ttn.train_step(state, to_device(pbatch, torch.device("cpu")), None,
                          tcfg, tloss, npos, times=times)
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


def test_eval_step_softmax_device_voxel_matches_jax(jstate):
    # Loss and EPE / AE of the bicubic-upsampled flow: rtol 1e-4.
    jcfg, tcfg = configs()
    jloss, tloss = loss_configs()
    batch = make_batch(4, gt=True)
    npos = batch["num_pos_events"]
    rng = jax.random.PRNGKey(6)
    jbatch, pbatch = split_batch(jcfg, batch, ("events", "lut_cell_ends",
                                               "flow_valid"))
    jbatch["gt_flow"] = jnp.asarray(batch["forward_flow"])
    want = jax.jit(functools.partial(jtn.eval_step, cfg=jcfg, loss_cfg=jloss,
                                     num_pos_events=npos))(jstate, jbatch, rng)
    state = port_state(tcfg, jstate)
    times = torch.tensor(np.asarray(jax_times(jloss, rng)))
    got = ttn.eval_step(state, to_device(pbatch, torch.device("cpu")), None,
                        tcfg, tloss, npos, times=times)
    for key in ("val_losses/EPE", "val_losses/AE", "val_losses/total"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-4, err_msg=key)


def test_step_voxelizes_with_or_without_cell_ends(jstate):
    # A batch without 'voxel' goes through the vote whether or not it
    # carries lut_cell_ends, and the voxel grid is the same.
    _, tcfg = configs()
    batch = make_batch(5)
    ev = torch.from_numpy(batch["events"])
    grids = ttn.voxelize_batch_on_device(tcfg, ev)
    state = port_state(tcfg, jstate)
    tloss = FocusLossConfig(**SOFTMAX_KW)
    times = torch.tensor([0.4] + [(i + 0.5) / NB for i in range(NB)])
    npos = batch["num_pos_events"]
    with_ends = {"events": ev, "lut_cell_ends": torch.from_numpy(
        batch["lut_cell_ends"])}
    losses = []
    state.model.eval()
    for b in (with_ends, {"events": ev}, {"events": ev, "voxel": grids}):
        with torch.no_grad():
            loss, _, _ = ttn._step(state.model, b, tloss, times, npos)
        losses.append(float(loss))
    # The loss of the sorted LUT path and of plain indexing differ only by
    # summation order; the given voxel and the step's own are equal.
    assert losses[1] == losses[2]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


def test_per_bin_band_default_follows_the_basis():
    # An unset interp_band_per_bin is on for the linear basis only.
    seen = []
    real = ttn.focus_loss

    def spy(cfg, *a, **k):
        seen.append(cfg.interp_band_per_bin)
        return real(cfg, *a, **k)

    batch = to_device(make_batch(6), torch.device("cpu"))
    times = torch.tensor([0.4] + [(i + 0.5) / NB for i in range(NB)])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttn, "focus_loss", spy)
        for basis, k in (("polynomial", 1), ("polynomial", 2), ("dct", 1)):
            cfg = ttn.TrajectoryNetConfig(image_shape=(H, W), num_bins=NB,
                                          unet_widths=WIDTHS,
                                          basis_type=basis, num_basis=k)
            model = ttn.create_train_state(cfg, "cpu").model.eval()
            with torch.no_grad():
                ttn._step(model, batch, FocusLossConfig(**SOFTMAX_KW), times,
                          batch_npos(batch))
        cfg_set = dataclasses.replace(FocusLossConfig(**SOFTMAX_KW),
                                      interp_band_per_bin=False)
        with torch.no_grad():
            ttn._step(model, batch, cfg_set, times, batch_npos(batch))
    assert seen == [True, False, False, False]


def batch_npos(batch):
    return batch["events"].shape[1] // 2


def test_train_flow_softmax_device_voxel_two_steps(tmp_path):
    # Two train steps and a val pass on batches without 'voxel'.
    tcfg = ttn.TrajectoryNetConfig(image_shape=(H, W), num_bins=NB,
                                   unet_widths=WIDTHS)
    loss_cfg = FocusLossConfig(**SOFTMAX_KW)

    def drop(b):
        return {k: v for k, v in b.items() if k != "voxel"}

    out = train_flow(tcfg, loss_cfg, [drop(make_batch(10)),
                                      drop(make_batch(11))],
                     [drop(make_batch(12, gt=True))], str(tmp_path),
                     device="cpu", max_epochs=1, log_every=1, seed=3)
    assert out["steps"] == 2 and np.isfinite(out["best"])
    recs = [json.loads(line) for line in
            (tmp_path / "scalars.jsonl").read_text().splitlines()]
    losses = [r["train_losses/total"] for r in recs
              if "train_losses/total" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[0] != losses[1]
    assert any(np.isfinite(r.get("val_losses/EPE", np.nan)) for r in recs)


def test_flow_train_cli_device_voxelize(tmp_path, monkeypatch):
    # The CLI with --device-voxelize on a synthetic DSEC tree: the provider
    # is asked for no host voxel, the collated batches carry none, and the
    # run trains and validates with knn_method softmax.
    from motionpriorcmax_tpu_torch.cli.main import main
    from motionpriorcmax_tpu_torch.data import dsec, loader

    data = tmp_path / "dsec"
    data.mkdir()
    make_synthetic_dsec_sequence(data, name="zurich_city_04_d")
    make_val_sequence(data)
    config = {
        "common": {"height": 480, "width": 640, "num_bins": 3,
                   "polarity_aware_batching": True, "patch_size": 16},
        "model": {"lr": 1e-4, "model_type": "default", "num_basis": 1,
                  "basis_type": "polynomial", "unet_widths": [4, 8, 8, 8, 8]},
        "loss": {"loss_name": "FOCUS", "num_tref": 1, "num_knn": 4,
                 "smooth_weight": 0.003, "lut_superpixel_size": 16,
                 "focus_loss_norm": "l1", "dist_norm": "l2",
                 "scale_iwe_by_dt": True, "mask_image_border": True,
                 "interpolation_scheme": "mean",
                 "smooth_type": "on_flow_to_tref", "knn_method": "softmax"},
        "data": {"dataset": "DSEC", "data_path": str(data), "num_workers": 2,
                 "batch_size": 2, "norm_type": "mean_std", "quantile": 0},
        "trainer": {"max_epochs": 1},
    }
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(config))
    host_voxelize, voxel_keys = [], []
    real_provider, real_collate = dsec.DsecDatasetProvider, loader.stack_samples

    def provider(*a, **k):
        host_voxelize.append(k["host_voxelize"])
        return real_provider(*a, **k)

    def collate(*a, **k):
        out = real_collate(*a, **k)
        voxel_keys.append("voxel" in out)
        return out

    monkeypatch.setattr(dsec, "DsecDatasetProvider", provider)
    monkeypatch.setattr(loader, "stack_samples", collate)
    workdir = tmp_path / "run"
    assert main(["flow-train", "--config", str(cfg_path), "--workdir",
                 str(workdir), "--event-capacity", "4096", "--log-every", "1",
                 "--device-voxelize", "--device", "cpu"]) == 0
    assert host_voxelize == [False, False]
    assert voxel_keys and not any(voxel_keys)
    recs = [json.loads(line) for line in
            (workdir / "scalars.jsonl").read_text().splitlines()]
    assert any(np.isfinite(r.get("train_losses/total", np.nan)) for r in recs)
    assert any(np.isfinite(r.get("val_losses/EPE", np.nan)) for r in recs)

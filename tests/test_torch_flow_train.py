"""Port's flow-training slice vs the JAX package, on the CPU: UNet weights
both ways, UNet forward and BatchNorm statistics, one full train step
(loss, parameters after AdamW, BatchNorm statistics), eval_step's EPE, and
2-step runs of train_flow and of the flow-train CLI.

Both sides run on the same weights: the JAX UNet's variables go through
`flax_unet_to_torch`.  The JAX UNet is narrowed to WIDTHS by a monkeypatch
of the name the JAX TrajectoryModel builds it from (nothing in the JAX
package changes).  t_ref comes from the JAX rng and is handed to the port.
"""

import functools
import importlib.util
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
from motionpriorcmax_tpu.training.checkpoint import torch_unet_to_flax
from motionpriorcmax_tpu.utils import save_flow_png
from motionpriorcmax_tpu_torch.data.collate import collate_fixed_capacity
from motionpriorcmax_tpu_torch.data.host_ops import voxelize_normalized_host
from motionpriorcmax_tpu_torch.losses import FocusLossConfig
from motionpriorcmax_tpu_torch.models.unet import UNet
from motionpriorcmax_tpu_torch.training import trajectory_net as ttn
from motionpriorcmax_tpu_torch.training.checkpoint import (
    flax_unet_to_torch, restore_checkpoint, save_checkpoint)
from motionpriorcmax_tpu_torch.training.loop import to_device, train_flow
from tests.test_data_dsec import make_synthetic_dsec_sequence
from tests._one_thread import one_torch_thread  # noqa: F401

H, W, NB = 32, 48, 15
WIDTHS = (8, 16, 16, 32, 32)
LOSS_KW = dict(image_shape=(H, W), num_bins=NB, num_knn=32)


@pytest.fixture(scope="module")
def jstate():
    """The JAX train state of the narrow UNet, built once for the module
    (the UNet name stays patched while the module's tests run)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtn, "UNet", functools.partial(jtn.UNet, widths=WIDTHS))
        yield jax_state(configs()[0])


def configs(compute_dtype="float32"):
    kw = dict(image_shape=(H, W), num_bins=NB, compute_dtype=compute_dtype)
    return (jtn.TrajectoryNetConfig(**kw),
            ttn.TrajectoryNetConfig(**kw, unet_widths=WIDTHS))


def jax_state(jcfg, seed=0):
    """A JAX train state whose output bias is large enough that the
    trajectories leave the grid (no KNN ties between the frameworks) and
    whose BatchNorm statistics are not the init's."""
    state = jtn.create_train_state(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    params["unet"]["Conv_0"]["bias"] = rng.normal(0, 2, 2).astype(np.float32)
    stats = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.uniform(0.5, 1.5, a.shape)
                   ).astype(np.float32), state.batch_stats)
    return state.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                         batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                            stats))


def port_state(tcfg, jstate):
    state = ttn.create_train_state(tcfg, "cpu")
    state.model.unet.load_state_dict(flax_unet_to_torch(
        jstate.params["unet"], jstate.batch_stats["unet"]))
    return state


def make_events(rng, n):
    t = np.sort(rng.uniform(0, 1, n))
    ev = np.stack([rng.uniform(0, H, n), rng.uniform(0, W, n), t,
                   rng.integers(0, 2, n),
                   np.clip(np.searchsorted(np.linspace(0, 1, NB + 1), t) - 1,
                           0, None)], -1)
    return ev.astype(np.float32)


def make_batch(seed, b=2, capacity=4096, n=2500, gt=False):
    """A cell-sorted, polarity-packed, host-voxelized batch (numpy)."""
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(b):
        ev = make_events(rng, n)
        s = {"pos_events": ev[ev[:, 3] == 1], "neg_events": ev[ev[:, 3] == 0],
             "voxel": voxelize_normalized_host(ev, NB, H, W)}
        if gt:
            s["forward_flow"] = rng.normal(0, 3, (2, H, W)).astype(np.float32)
            s["flow_valid"] = rng.uniform(size=(H, W)) < 0.7
        samples.append(s)
    return collate_fixed_capacity(samples, capacity, True,
                                  lut_cell_sort_params=((H, W), NB, 4))


def flat_unet(params, stats):
    out = {}
    for coll, tree in (("params", params), ("stats", stats)):
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[(coll,) + tuple(k.key for k in path)] = np.asarray(v)
    return out


def test_unet_weights_round_trip_through_jax_converter(jstate):
    # flax -> port state_dict -> JAX torch_unet_to_flax: every tensor back
    # bit for bit, and the port's UNet takes the state_dict strictly.
    sd = flax_unet_to_torch(jstate.params["unet"], jstate.batch_stats["unet"])
    UNet(NB, 2, widths=WIDTHS).load_state_dict(sd, strict=True)
    params, stats = torch_unet_to_flax({k: v.numpy() for k, v in sd.items()})
    want = flat_unet(jstate.params["unet"], jstate.batch_stats["unet"])
    got = flat_unet(params, stats)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


@pytest.mark.parametrize("train", [False, True])
def test_unet_f32_forward_and_batchnorm_match_jax(jstate, train):
    # f32 convolutions sum in another order (Eigen vs oneDNN): outputs to
    # 1e-4 of their largest value.  Train mode: the running statistics move
    # with flax's momentum and biased E[x^2] - E[x]^2 variance: rtol 1e-4.
    jcfg, tcfg = configs()
    x = np.random.default_rng(1).normal(size=(2, NB, H, W)).astype(np.float32)
    model = jtn.TrajectoryModel(jcfg)
    variables = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    if train:
        want, mutated = jax.jit(functools.partial(
            model.apply, train=True, mutable=["batch_stats"]))(
                variables, jnp.asarray(x))
    else:
        want = jax.jit(functools.partial(model.apply, train=False))(
            variables, jnp.asarray(x))
    want = np.asarray(want)
    state = port_state(tcfg, jstate)
    state.model.train(train)
    with torch.no_grad():
        got = state.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    if train:
        sd = flax_unet_to_torch(jstate.params["unet"],
                                mutated["batch_stats"]["unet"])
        ours = state.model.unet.state_dict()
        for k, v in sd.items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(ours[k].numpy(), v.numpy(),
                                           rtol=1e-4, atol=1e-6, err_msg=k)


def test_unet_bf16_forward_close_to_jax(jstate):
    # bf16 convolutions and activations (8 mantissa bits) with f32
    # statistics and an f32 output conv: 5e-2 of the largest value.
    jcfg, tcfg = configs("bfloat16")
    x = np.random.default_rng(2).normal(size=(2, NB, H, W)).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(
        jtn.TrajectoryModel(jcfg).apply, train=False))(
            {"params": jstate.params, "batch_stats": jstate.batch_stats},
            jnp.asarray(x)))
    state = port_state(tcfg, jstate)
    state.model.eval()
    with torch.no_grad():
        got = state.model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=5e-2 * np.abs(want).max())


def test_train_step_matches_jax(jstate):
    """One AdamW step on the same weights, batch and t_ref.

    Loss rtol 1e-4 (f32 UNet, vote order).  AdamW's first step moves each
    parameter by ~lr * sign(grad): updates agree to 1e-6 (1% of lr = 1e-4)
    wherever the gradient is not at rounding level, checked on all
    parameters at atol 2e-6 after excluding entries whose JAX gradient is
    below 1e-6 of the layer's largest.  BatchNorm statistics rtol 1e-4."""
    jcfg, tcfg = configs()
    jloss, tloss = JaxFocusCfg(**LOSS_KW), FocusLossConfig(**LOSS_KW)
    batch = make_batch(3)
    npos = batch["num_pos_events"]
    rng = jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(batch[k])
              for k in ("events", "voxel", "lut_cell_ends")}

    @jax.jit
    def loss_fn(params):
        # jtn.train_step's loss, with the gradient kept for the check below.
        loss, (_, _, new_bs, _) = jtn._step(
            jcfg, jloss, params, jstate.batch_stats, jbatch, rng, train=True,
            num_pos_events=npos)
        return loss, new_bs

    (jloss_val, new_bs), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(jstate.params)
    new_jstate = jstate.apply_gradients(grads=grads, batch_stats=new_bs)

    state = port_state(tcfg, jstate)
    before = {k: v.clone() for k, v in state.model.unet.state_dict().items()}
    times = torch.tensor(np.asarray(jax_times(jloss, rng)))
    logs = ttn.train_step(state, to_device(batch, torch.device("cpu")), None,
                          tcfg, tloss, npos, times=times)
    np.testing.assert_allclose(float(logs["train_losses/total"]),
                               float(jloss_val), rtol=1e-4)

    after = flax_unet_to_torch(new_jstate.params["unet"],
                               new_jstate.batch_stats["unet"])
    gsd = flax_unet_to_torch(grads["unet"], jstate.batch_stats["unet"])
    ours = state.model.unet.state_dict()
    checked = 0
    for k, want in after.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(ours[k].numpy(), want.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
            continue
        g = gsd[k].numpy()
        live = np.abs(g) > 1e-6 * np.abs(g).max()
        d_ours = (ours[k] - before[k]).numpy()
        d_jax = (want - before[k]).numpy()
        np.testing.assert_allclose(d_ours[live], d_jax[live], rtol=0,
                                   atol=2e-6, err_msg=k)
        checked += int(live.sum())
    assert checked > 0.9 * sum(v.numel() for k, v in after.items()
                               if k.endswith(("weight", "bias")))


def test_eval_step_epe_matches_jax(jstate):
    # EPE of the bicubic-upsampled flow over GT-valid pixels: rtol 1e-4.
    jcfg, tcfg = configs()
    jloss, tloss = JaxFocusCfg(**LOSS_KW), FocusLossConfig(**LOSS_KW)
    batch = make_batch(4, gt=True)
    npos = batch["num_pos_events"]
    rng = jax.random.PRNGKey(6)
    jbatch = {k: jnp.asarray(batch[k]) for k in
              ("events", "voxel", "lut_cell_ends", "flow_valid")}
    jbatch["gt_flow"] = jnp.asarray(batch["forward_flow"])
    want = jax.jit(functools.partial(jtn.eval_step, cfg=jcfg, loss_cfg=jloss,
                                     num_pos_events=npos))(jstate, jbatch, rng)
    state = port_state(tcfg, jstate)
    times = torch.tensor(np.asarray(jax_times(jloss, rng)))
    got = ttn.eval_step(state, to_device(batch, torch.device("cpu")), None,
                        tcfg, tloss, npos, times=times)
    for key in ("val_losses/EPE", "val_losses/AE", "val_losses/total"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-4, err_msg=key)


def test_train_flow_two_steps_and_best_k(tmp_path):
    # Two train steps, one val pass with GT flow, a checkpoint kept by its
    # EPE; restoring it gives back the weights.
    tcfg = ttn.TrajectoryNetConfig(image_shape=(H, W), num_bins=NB,
                                   unet_widths=WIDTHS)
    loss_cfg = FocusLossConfig(**LOSS_KW)
    train = [make_batch(10), make_batch(11)]
    val = [make_batch(12, gt=True)]
    out = train_flow(tcfg, loss_cfg, train, val, str(tmp_path), device="cpu",
                     max_epochs=1, log_every=1, seed=3)
    assert out["steps"] == 2 and np.isfinite(out["best"])
    recs = [json.loads(line) for line in
            (tmp_path / "scalars.jsonl").read_text().splitlines()]
    losses = [r["train_losses/total"] for r in recs if "train_losses/total" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[0] != losses[1]
    assert any(np.isfinite(r.get("val_losses/EPE", np.nan)) for r in recs)

    state = ttn.create_train_state(tcfg, "cpu",
                                   torch.Generator().manual_seed(99))
    restored, step = restore_checkpoint(str(tmp_path / "checkpoints"), state,
                                        best=True)
    assert step == 2 and restored.step == 2


def test_checkpoint_best_k_retention(tmp_path):
    tcfg = ttn.TrajectoryNetConfig(image_shape=(H, W), num_bins=NB,
                                   unet_widths=WIDTHS)
    state = ttn.create_train_state(tcfg, "cpu")
    for step, metric in ((1, 3.0), (2, 1.0), (3, 2.0), (4, 5.0)):
        state.step = step
        save_checkpoint(str(tmp_path), state, step, keep=2, metric=metric)
    assert sorted(p.name for p in tmp_path.glob("*.pt")) == [
        "step_2.pt", "step_3.pt"]
    fresh = ttn.create_train_state(tcfg, "cpu",
                                   torch.Generator().manual_seed(1))
    _, step = restore_checkpoint(str(tmp_path), fresh, best=True)
    assert step == 2
    for a, b in zip(fresh.model.parameters(), state.model.parameters()):
        assert torch.equal(a, b)


def sensor_sequence(root, name, hw=(480, 640)):
    """make_synthetic_dsec_sequence on a sensor of `hw` (its 480 x 640
    events moved onto the smaller sensor, an identity rectify map of
    `hw`)."""
    import h5py

    seq = make_synthetic_dsec_sequence(root, name=name)
    h, w = hw
    if hw != (480, 640):
        with h5py.File(seq / "events/left/events.h5", "r+") as f:
            for key, size, full in (("x", w, 640), ("y", h, 480)):
                v = f[f"events/{key}"][()].astype(np.int64) * size // full
                f[f"events/{key}"][...] = v.astype(f[f"events/{key}"].dtype)
        gx, gy = np.meshgrid(np.arange(w), np.arange(h))
        with h5py.File(seq / "events/left/rectify_map.h5", "w") as f:
            f.create_dataset("rectify_map", data=np.stack(
                [gx, gy], axis=-1).astype("float32"))
    return seq


def make_val_sequence(root, name="zurich_city_05_b", n_windows=2,
                      hw=(480, 640)):
    """A val-phase DSEC sequence with GT flow PNGs (as in
    tests/test_flow_train_cli.py): `n_windows` (at most 3) windows of 100
    ms from 100 ms on, on a sensor of `hw`."""
    rng = np.random.default_rng(7)
    seq = sensor_sequence(root, name, hw)
    flow_dir = seq / "flow/forward"
    flow_dir.mkdir(parents=True)
    (seq / "flow/forward_timestamps.txt").write_text(
        "# from_timestamp_us, to_timestamp_us\n" + "".join(
            f"{t}00000,{t + 1}00000\n" for t in range(1, n_windows + 1)))
    for idx in range(2, 2 * n_windows + 1, 2):
        flow = rng.normal(size=(2,) + hw).astype(np.float32) * 3
        save_flow_png(flow_dir / f"{idx:06d}.png", flow,
                      rng.uniform(size=hw) < 0.7)
    return seq


# The CLI test's sensor: the DSEC reader's 480 x 640 cut (its HEIGHT and
# WIDTH patched), a multiple of the UNet's 16.
CLI_HW = (64, 96)


def test_flow_train_cli_two_steps(tmp_path, monkeypatch):
    # The CLI on a synthetic DSEC tree of a CLI_HW sensor, a narrow UNet
    # and a coarse LUT: 2 epochs of 1 step, val EPE, best-k checkpoints,
    # resume.
    from motionpriorcmax_tpu_torch.cli.main import main
    from motionpriorcmax_tpu_torch.data import dsec

    h, w = CLI_HW
    monkeypatch.setattr(dsec, "HEIGHT", h)
    monkeypatch.setattr(dsec, "WIDTH", w)
    data = tmp_path / "dsec"
    data.mkdir()
    sensor_sequence(data, "zurich_city_04_d", CLI_HW)
    make_val_sequence(data, hw=CLI_HW)
    config = {
        "common": {"height": h, "width": w, "num_bins": 3,
                   "polarity_aware_batching": True, "patch_size": 16},
        "model": {"lr": 1e-4, "model_type": "default", "num_basis": 1,
                  "basis_type": "polynomial", "unet_widths": [4, 8, 8, 8, 8]},
        "loss": {"loss_name": "FOCUS", "num_tref": 1, "num_knn": 4,
                 "smooth_weight": 0.003, "lut_superpixel_size": 16,
                 "focus_loss_norm": "l1", "dist_norm": "l2",
                 "scale_iwe_by_dt": True, "mask_image_border": True,
                 "interpolation_scheme": "mean",
                 "smooth_type": "on_flow_to_tref"},
        "data": {"dataset": "DSEC", "data_path": str(data), "num_workers": 2,
                 "batch_size": 2, "norm_type": "mean_std", "quantile": 0},
        "trainer": {"max_epochs": 2},
    }
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(config))
    workdir = tmp_path / "run"
    args = ["flow-train", "--config", str(cfg_path), "--workdir", str(workdir),
            "--event-capacity", "4096", "--log-every", "1", "--device", "cpu"]
    assert main(args) == 0
    log = (workdir / "scalars.jsonl").read_text()
    assert "train_losses/total" in log and "val_losses/EPE" in log
    assert len(list((workdir / "checkpoints").glob("step_*.pt"))) == 2
    # Each epoch's image panel: 5 val samples x 5 images, named as the JAX
    # package names them, and the scalars' TensorBoard mirror.
    pngs = sorted(p.name for p in (workdir / "images").glob("*.png"))
    assert len(pngs) == 50 and {p[:6] for p in pngs} == {"000001", "000002"}
    assert {"000002_04_val_0_unwarped.png", "000002_04_val_1_gt_iwe.png",
            "000002_04_val_2_iwe.png", "000002_04_val_3_gt_flow.png",
            "000002_04_val_4_flow.png"} <= set(pngs)
    if importlib.util.find_spec("tensorboard") is not None:
        assert list((workdir / "tb").glob("events.out.tfevents.*"))

    config["trainer"]["max_epochs"] = 1
    cfg_path.write_text(yaml.safe_dump(config))
    assert main(args[:4] + [str(tmp_path / "run2")] + args[5:]
                + ["--ckp_path", str(workdir / "checkpoints")]) == 0
    steps = [json.loads(line)["step"] for line in
             (tmp_path / "run2" / "scalars.jsonl").read_text().splitlines()]
    assert max(steps) == 3
    assert len(list((tmp_path / "run2" / "images").glob("000003_*.png"))) == 25


def test_flow_train_cli_defaults_to_cuda(tmp_path, monkeypatch):
    from motionpriorcmax_tpu_torch.cli.main import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="cuda"):
        main(["flow-train", "--config", str(tmp_path / "none.yaml")])


def test_chip_smoke_drives_dsec_yaml():
    # card_cases.py carries config/flow_training/dsec.yaml as a dict for
    # chip_smoke.py (the GPU machine has no yaml): the two must agree.
    import card_cases

    with open("config/flow_training/dsec.yaml") as fh:
        assert card_cases.DSEC_CONFIG == yaml.safe_load(fh)

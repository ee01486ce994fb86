"""The port's DSEC inference (dsec-infer, extract-weights) vs the JAX
package, on the CPU: the test-phase reader, the flow of one 480 x 640
window from the same weights and events, each of the four weight sources,
and the CLI end to end, also from the port's own flow-train checkpoint.

The port votes the voxel grid with the voxel vote's plain version (a CPU
tensor); JAX with `voxel_grid_from_events(scatter_impl='direct')`, as its
dsec-infer does.  The JAX UNet is narrowed to WIDTHS by a monkeypatch of
the name its TrajectoryModel builds it from (nothing in the JAX package
changes).  Flow tolerance: 1e-4 of max(1, max |flow|) (f32 convolutions
summed in another order).
"""

import csv
import functools
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

import motionpriorcmax_tpu.training.trajectory_net as jtn
from motionpriorcmax_tpu.data.dsec import DsecSequence as JaxSequence
from motionpriorcmax_tpu.ops.events import voxel_grid_from_events as jvoxel
from motionpriorcmax_tpu.ops.events import normalize_voxel_grid as jnorm
from motionpriorcmax_tpu.training.checkpoint import flatten_model_weights
from motionpriorcmax_tpu.utils import scale_optical_flow as jscale
from motionpriorcmax_tpu_torch.cli.main import infer_sequence, main
from motionpriorcmax_tpu_torch.data.dsec import DsecSequence
from motionpriorcmax_tpu_torch.ops import events as tev
from motionpriorcmax_tpu_torch.training import trajectory_net as ttn
from motionpriorcmax_tpu_torch.training.checkpoint import (
    flax_unet_to_torch, load_flow_model_weights, save_checkpoint)
from motionpriorcmax_tpu_torch.utils.flow_io import load_flow_png
from tests.test_data_dsec import make_synthetic_dsec_sequence
from tests.test_torch_flow_train import make_val_sequence

NB = 15
WIDTHS = (4, 8, 8, 8, 8)
SEQ = "zurich_city_99_z"
ROWS = ((100000, 200000, 42), (200000, 300000, 44))
TOL_FLOW = 1e-4


def write_csv(path: Path, rows):
    """A benchmark timestamp CSV, a space after each comma as in
    config/misc/dsec_test_timestamps."""
    path.write_text("from_timestamp_us,to_timestamp_us,file_index\n" + "".join(
        f"{a}, {b}, {c}\n" for a, b, c in rows))
    return path


def jax_state(jcfg, seed=0):
    """A JAX train state of the narrow UNet whose BatchNorm statistics are
    not the init's but keep its activations alive, and whose output conv is
    scaled up: the flow varies by pixels over the image and depends on
    every layer, not on the output bias alone."""
    state = jtn.create_train_state(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    params["unet"]["Conv_0"]["kernel"] = params["unet"]["Conv_0"][
        "kernel"] * 100.0
    stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)

    def shift(path, a):
        if path[-1].key == "mean":
            return (a + rng.uniform(-0.2, 0.2, a.shape)).astype(np.float32)
        return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(shift, stats)
    return state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))


def fractional_rectify(seq):
    """Sub-pixel offsets, pixels mapped out of the image and onto its last
    row and column (y = 479.7, x = 639.6)."""
    rng = np.random.default_rng(3)
    rect = seq.rectify_ev_map + rng.uniform(-0.6, 0.6,
                                            seq.rectify_ev_map.shape)
    rect[:4] = -3.0
    rect[-8:, :, 1] = 479.7
    rect[:, -8:, 0] = 639.6
    return rect.astype(np.float32)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A DSEC test tree with one sequence, its two-row CSV, the JAX state
    of the narrow UNet, and the JAX flow of the CSV's first window on
    integer and on fractional rectified coordinates, and of a window
    without events."""
    root = tmp_path_factory.mktemp("dsec")
    (root / "dsec/test").mkdir(parents=True)
    make_synthetic_dsec_sequence(root / "dsec/test", name=SEQ,
                                 n_events=400_000)
    ts_dir = root / "timestamps"
    ts_dir.mkdir()
    csv_path = write_csv(ts_dir / f"{SEQ}.csv", ROWS)
    jcfg = jtn.TrajectoryNetConfig(image_shape=(480, 640), num_bins=NB)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtn, "UNet", functools.partial(jtn.UNet, widths=WIDTHS))
        jstate = jax_state(jcfg)
        predict = jax.jit(lambda s, v: jtn.predict_flow(s, v, jcfg))
        seq = JaxSequence(root / "dsec/test" / SEQ, "test", NB,
                          timestamp_path=str(csv_path))
        events = {"integer": seq[0]["events"]}
        seq.rectify_ev_map = fractional_rectify(seq)
        events["fractional"] = seq[0]["events"]
        events["empty"] = np.zeros((0, 5), np.float32)
        flows = {}
        for kind, ev in events.items():
            voxel = jvoxel(jnp.asarray(ev[:, 0]), jnp.asarray(ev[:, 1]),
                           jnp.asarray(ev[:, 2] * (NB - 1)),
                           jnp.asarray(ev[:, 3]), jnp.ones(len(ev)),
                           num_bins=NB, height=480, width=640,
                           scatter_impl="direct")
            flows[kind] = np.asarray(predict(jstate, jnorm(voxel)[None]))[0]
    return {"root": root, "ts_dir": ts_dir, "csv": csv_path,
            "jstate": jstate, "events": events, "flows": flows}


def port_flow(model_state, events):
    """The port's flow of one window's packed [N, 5] events (CPU)."""
    rows = torch.from_numpy(np.concatenate(
        [events, np.ones((len(events), 1), np.float32)], 1))[None]
    voxel = tev.normalize_voxel_grid(tev.voxel_grid_from_events(
        rows, num_bins=NB, height=480, width=640))
    return ttn.predict_flow(model_state, voxel, model_state.model.cfg)[0]


def port_cfg():
    return ttn.TrajectoryNetConfig(image_shape=(480, 640), num_bins=NB,
                                   unet_widths=WIDTHS)


def unet_state_dict(jstate):
    return flax_unet_to_torch(jstate.params["unet"],
                              jstate.batch_stats["unet"])


def assert_flow_close(got, want, live=True):
    assert got.shape == want.shape == (2, 480, 640)
    if live:
        # A flow that varies over the image: every layer took part.
        assert want.std(axis=(1, 2)).min() > 1e2 * TOL_FLOW * max(
            1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL_FLOW * max(1.0, np.abs(want).max()))


def test_test_phase_sequence_matches_jax(tree):
    # Timestamps, file indices and the packed events of each window equal
    # JAX's; no GT.  The same sequence over a mapping of numpy arrays (no
    # h5py) and a rectify map gives the same samples.
    import h5py

    path = tree["root"] / "dsec/test" / SEQ
    port = DsecSequence(path, "test", NB, timestamp_path=str(tree["csv"]))
    ref = JaxSequence(path, "test", NB, timestamp_path=str(tree["csv"]))
    np.testing.assert_array_equal(port.timestamps_flow, ref.timestamps_flow)
    np.testing.assert_array_equal(port.indices, [42, 44])
    with h5py.File(path / "events/left/events.h5", "r") as fh:
        arrays = {k: np.asarray(fh[k]) for k in
                  ("events/p", "events/x", "events/y", "events/t",
                   "ms_to_idx", "t_offset")}
    mem = DsecSequence(Path("anywhere") / SEQ, "test", NB,
                       timestamp_path=str(tree["csv"]), event_file=arrays,
                       rectify_map=port.rectify_ev_map.copy())
    assert len(port) == len(ref) == len(mem) == 2
    for i in range(2):
        want = ref[i]
        for got in (port[i], mem[i]):
            assert "forward_flow" not in got
            assert got["name"] == want["name"] == f"{SEQ}_{ROWS[i][2]:06d}"
            assert int(got["file_index"]) == ROWS[i][2]
            np.testing.assert_array_equal(got["timestamp"], want["timestamp"])
            np.testing.assert_array_equal(got["events"], want["events"])
    with pytest.raises(ValueError, match="timestamp"):
        DsecSequence(path, "test", NB)
    with pytest.raises(ValueError, match="together"):
        DsecSequence(path, "test", NB, timestamp_path=str(tree["csv"]),
                     event_file=arrays)


def test_benchmark_csvs_load():
    # The seven benchmark CSVs: 416 windows, their file indices as a plain
    # csv read gives them.
    arrays = {"events/p": np.zeros(1, np.uint8),
              "events/x": np.zeros(1, np.uint16),
              "events/y": np.zeros(1, np.uint16),
              "events/t": np.zeros(1, np.int64),
              "ms_to_idx": np.zeros(2, np.int64),
              "t_offset": np.asarray(0, np.int64)}
    total = 0
    for path in sorted(Path("config/misc/dsec_test_timestamps").glob("*.csv")):
        seq = DsecSequence(Path(path.stem), "test", NB,
                           timestamp_path=str(path), event_file=arrays,
                           rectify_map=np.zeros((480, 640, 2), np.float32))
        with open(path) as fh:
            rows = list(csv.DictReader(fh))
        np.testing.assert_array_equal(
            seq.indices, [int(r["file_index"]) for r in rows])
        assert (seq.timestamps_flow[:, 1] > seq.timestamps_flow[:, 0]).all()
        total += len(seq)
    assert total == 416


@pytest.mark.parametrize("kind", ["integer", "fractional", "empty"])
def test_window_flow_matches_jax_predict_flow(tree, kind):
    # One window at 480 x 640 on the same weights and events: the plain
    # voxel vote + normalization + predict_flow against JAX's.  A window
    # without events gives an all-zero grid, left as it is by the
    # normalization, on both sides.
    state = ttn.create_train_state(port_cfg(), "cpu")
    state.model.unet.load_state_dict(unet_state_dict(tree["jstate"]))
    assert_flow_close(port_flow(state, tree["events"][kind]).numpy(),
                      tree["flows"][kind], live=kind != "empty")


@pytest.mark.parametrize("source", ["ckpt", "params_npz", "torch_npz",
                                    "checkpoint_dir"])
def test_weight_sources_give_jax_flow(tree, tmp_path, source):
    # Each weight source that dsec-infer reads fills a model whose flow is
    # JAX's on the same weights.
    jstate = tree["jstate"]
    sd = unet_state_dict(jstate)
    if source == "ckpt":
        # A Lightning checkpoint: the UNet under 'model.'.
        path = tmp_path / "ref.ckpt"
        torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()
                                   if not k.endswith("num_batches_tracked")}},
                   path)
    elif source == "params_npz":
        path = tmp_path / "jax.npz"
        np.savez(path, **flatten_model_weights(jstate.params, "params"),
                 **flatten_model_weights(jstate.batch_stats, "batch_stats"))
    elif source == "torch_npz":
        path = tmp_path / "torch.npz"
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    else:
        owner = ttn.create_train_state(port_cfg(), "cpu")
        owner.model.unet.load_state_dict(sd)
        save_checkpoint(str(tmp_path / "run" / "checkpoints"), owner, 3,
                        metric=1.0)
        path = tmp_path / "run"
    state = ttn.create_train_state(port_cfg(), "cpu",
                                   torch.Generator().manual_seed(5))
    what = load_flow_model_weights(state.model, str(path))
    assert str(path) in what
    assert_flow_close(port_flow(state, tree["events"]["integer"]).numpy(),
                      tree["flows"]["integer"])


def infer_config(tmp_path, tree, ckpt, out_name, num_bins=NB, patch=4,
                 widths=WIDTHS):
    config = {
        "common": {"height": 480, "width": 640, "num_bins": num_bins,
                   "patch_size": patch},
        "model": {"num_basis": 1, "basis_type": "polynomial", "lr": 1e-4,
                  "model_type": "default", "ckpt_path": str(ckpt),
                  "unet_widths": list(widths)},
        "data": {"root_dir": str(tree["root"] / "dsec"),
                 "norm_type": "mean_std"},
        "output_dir": str(tmp_path / out_name),
    }
    path = tmp_path / f"{out_name}.yaml"
    path.write_text(yaml.safe_dump(config))
    return path


def run_infer(tmp_path, tree, ckpt, out_name, **kw):
    cfg = infer_config(tmp_path, tree, ckpt, out_name, **kw)
    assert main(["dsec-infer", "--config", str(cfg), "--timestamp-dir",
                 str(tree["ts_dir"]), "--device", "cpu"]) == 0
    pngs = sorted((tmp_path / out_name).rglob("*.png"))
    assert [p.name for p in pngs] == ["000042.png", "000044.png"]
    assert pngs[0].parent.name == SEQ and pngs[0].parent.parent.name == "flow"
    return pngs


def test_dsec_infer_cli_end_to_end(tree, tmp_path):
    # The CLI on the synthetic test tree from a reference .pth: two PNGs,
    # 000042.png first, finite, within the 60 px cap (each component is
    # rounded down to a 1/128 px step: sqrt(2) / 128 px on the magnitude);
    # the first equals JAX's flow, capped and quantized, within 1/128 px
    # plus the flow tolerance.
    path = tmp_path / "model.pth"
    torch.save(unet_state_dict(tree["jstate"]), path)
    pngs = run_infer(tmp_path, tree, path, "out")
    for png in pngs:
        flow, _ = load_flow_png(png)
        assert flow.shape == (2, 480, 640) and np.isfinite(flow).all()
        assert np.sqrt((flow ** 2).sum(0)).max() <= 60 + np.sqrt(2) / 128
    flow, _ = load_flow_png(pngs[0])
    want = jscale(tree["flows"]["integer"], 60)
    np.testing.assert_allclose(flow, want, rtol=0, atol=1 / 128 + TOL_FLOW
                               * max(1.0, np.abs(want).max()))


def test_dsec_infer_from_own_training_and_extract_weights(tmp_path, tree):
    # flow-train for one step (its batches padded to capacity buckets),
    # dsec-infer from its checkpoint directory, then the extract-weights
    # .npz detour: the same PNG bytes.
    data = tmp_path / "dsec"
    data.mkdir()
    make_synthetic_dsec_sequence(data, name="zurich_city_04_d")
    make_val_sequence(data)
    train_cfg = {
        "common": {"height": 480, "width": 640, "num_bins": 3,
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
        "trainer": {"max_epochs": 1},
    }
    cfg_path = tmp_path / "train.yaml"
    cfg_path.write_text(yaml.safe_dump(train_cfg))
    workdir = tmp_path / "run"
    assert main(["flow-train", "--config", str(cfg_path), "--workdir",
                 str(workdir), "--event-capacity", "4096", "--log-every", "1",
                 "--event-capacity-buckets", "1024,2048,4096",
                 "--device", "cpu"]) == 0
    assert "train_losses/total" in (workdir / "scalars.jsonl").read_text()
    kw = dict(num_bins=3, patch=16, widths=(4, 8, 8, 8, 8))
    from_dir = run_infer(tmp_path, tree, workdir, "out_dir", **kw)
    npz = tmp_path / "weights.npz"
    assert main(["extract-weights", str(workdir / "checkpoints"),
                 str(npz)]) == 0
    with np.load(npz) as z:
        assert "inc.double_conv.0.weight" in z.files
    from_npz = run_infer(tmp_path, tree, npz, "out_npz", **kw)
    for a, b in zip(from_dir, from_npz):
        assert a.read_bytes() == b.read_bytes()


def test_infer_sequence_parts_seen_by_chip_smoke(tree, tmp_path):
    # The per-sequence function that chip_smoke.py drives on the card, with
    # chip_smoke's part timers wrapped round the functions it looks up by
    # name: every part in order, once per window, and the PNGs as without
    # the timers.
    import chip_smoke

    state = ttn.create_train_state(port_cfg(), "cpu")
    seq = DsecSequence(tree["root"] / "dsec/test" / SEQ, "test", NB,
                       timestamp_path=str(tree["csv"]))
    parts = []
    with chip_smoke.infer_part_marks(state, seq, parts.append) as marked:
        n = infer_sequence(state, port_cfg(), marked, tmp_path / "flow",
                           "mean_std", torch.device("cpu"))
    assert n == 2 and parts == 2 * list(chip_smoke.INFER_PARTS)
    infer_sequence(state, port_cfg(), seq, tmp_path / "plain", "mean_std",
                   torch.device("cpu"))
    names = ["000042.png", "000044.png"]
    assert sorted(p.name for p in (tmp_path / "flow").iterdir()) == names
    for name in names:
        assert ((tmp_path / "flow" / name).read_bytes()
                == (tmp_path / "plain" / name).read_bytes())


def test_dsec_infer_refuses_missing_card_and_unknown_weights(
        tree, tmp_path, monkeypatch):
    cfg = infer_config(tmp_path, tree, tmp_path / "weights.bin", "out")
    with pytest.raises(SystemExit, match="weights.bin"):
        main(["dsec-infer", "--config", str(cfg), "--timestamp-dir",
              str(tree["ts_dir"]), "--device", "cpu"])
    (tmp_path / "empty").mkdir()
    cfg = infer_config(tmp_path, tree, tmp_path / "empty", "out")
    with pytest.raises(SystemExit, match="no index.json"):
        main(["dsec-infer", "--config", str(cfg), "--timestamp-dir",
              str(tree["ts_dir"]), "--device", "cpu"])
    with pytest.raises(SystemExit, match="no checkpoint"):
        main(["extract-weights", str(tmp_path / "empty"),
              str(tmp_path / "w.npz")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="cuda"):
        main(["dsec-infer", "--config", str(cfg)])


def test_learned_basis_weights_from_jax_npz_and_extract(tmp_path):
    # A learned-basis model: the JAX 'params/...' npz fills the port's UNet
    # and basis MLP (Dense kernels transposed), whose basis matrix equals
    # JAX's; extract-weights' torch-key layout carries the MLP under
    # 'basis_mlp.' and loads back strictly.
    kw = dict(image_shape=(32, 48), num_bins=NB, basis_type="learned",
              num_basis=2)
    jcfg = jtn.TrajectoryNetConfig(**kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtn, "UNet", functools.partial(jtn.UNet, widths=WIDTHS))
        jstate = jtn.create_train_state(jcfg, jax.random.PRNGKey(1))
    path = tmp_path / "jax.npz"
    np.savez(path, **flatten_model_weights(jstate.params, "params"),
             **flatten_model_weights(jstate.batch_stats, "batch_stats"))
    tcfg = ttn.TrajectoryNetConfig(**kw, unet_widths=WIDTHS)
    state = ttn.create_train_state(tcfg, "cpu",
                                   torch.Generator().manual_seed(7))
    load_flow_model_weights(state.model, str(path))
    times = np.linspace(0, 1, 5).astype(np.float32)
    want = np.asarray(jtn.TrajectoryModel(jcfg).apply(
        {"params": jstate.params}, jnp.asarray(times),
        method=jtn.TrajectoryModel.basis))
    got = state.model.basis(torch.from_numpy(times)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    save_checkpoint(str(tmp_path / "run"), state, 1, metric=0.5)
    npz = tmp_path / "torch.npz"
    assert main(["extract-weights", str(tmp_path / "run"), str(npz)]) == 0
    with np.load(npz) as z:
        assert "basis_mlp.layers.0.weight" in z.files
    again = ttn.create_train_state(tcfg, "cpu",
                                   torch.Generator().manual_seed(8))
    load_flow_model_weights(again.model, str(npz))
    for a, b in zip(again.model.state_dict().values(),
                    state.model.state_dict().values()):
        assert torch.equal(a, b)
    plain = ttn.create_train_state(ttn.TrajectoryNetConfig(
        image_shape=(32, 48), num_bins=NB, num_basis=2, unet_widths=WIDTHS),
        "cpu")
    with pytest.raises(ValueError, match="learned basis"):
        load_flow_model_weights(plain.model, str(path))

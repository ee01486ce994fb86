"""flow-train's epoch image panels and the TensorBoard mirror of the
scalars: the port against the JAX package on the CPU.

The colorizations are the same NumPy code and must give the same bytes.
The render function runs on the narrow UNet of tests/test_torch_flow_train
(32 x 48, 15 bins; JAX weights carried over), with JAX's t_ref handed to
the port.  Its float outputs are held to 1e-4 of each output's largest
|value| (the f32 step of the flow-train tests agrees to ~1e-6 relative;
the panel's IWEs are that step's, voted by the same kernels' plain
versions).
"""

import json

import jax
import numpy as np
import pytest
import torch

import motionpriorcmax_tpu.training.loop as jloop
from motionpriorcmax_tpu.losses import FocusLossConfig as JaxFocusCfg
from motionpriorcmax_tpu.losses import get_reconstruction_times as jax_times
from motionpriorcmax_tpu.utils import image_logging as jil
from motionpriorcmax_tpu.utils import visualization as jvis
from motionpriorcmax_tpu_torch.losses import FocusLossConfig
from motionpriorcmax_tpu_torch.training import loop as tloop
from motionpriorcmax_tpu_torch.utils import image_logging as til
from motionpriorcmax_tpu_torch.utils import visualization as tvis
from motionpriorcmax_tpu_torch.utils.png16 import read_png_rgb, write_png8_rgb
from tests.test_torch_flow_train import (LOSS_KW, configs, jstate,  # noqa: F401
                                         make_batch, port_state)
from tests._one_thread import one_torch_thread  # noqa: F401

PANEL = ("unwarped_iwe", "pred_iwe", "pred_flow", "gt_flow", "gt_iwe")


def _flows():
    rng = np.random.default_rng(0)
    flow = rng.normal(0, 4, (2, 24, 30)).astype(np.float32)
    odd = flow.copy()
    odd[0, :3, :3] = np.nan
    odd[1, 5, :4] = np.inf
    odd[0, 7, 2:6] = -np.inf
    return {"normal": flow, "non-finite": odd,
            "zero": np.zeros((2, 24, 30), np.float32)}


@pytest.mark.parametrize("kind", ["normal", "non-finite", "zero"])
def test_flow_to_rgb_equals_jax_bytes(kind):
    flow = _flows()[kind]
    with np.errstate(invalid="ignore"):
        want = jvis.flow_to_rgb(flow.copy())
        got = tvis.flow_to_rgb(flow.copy())
    assert got.dtype == np.uint8 and got.shape == (24, 30, 3)
    assert got.tobytes() == want.tobytes()
    got = tvis.flow_to_rgb(flow.copy(), max_magnitude=3.0, ord=0.5)
    with np.errstate(invalid="ignore"):
        want = jvis.flow_to_rgb(flow.copy(), max_magnitude=3.0, ord=0.5)
    assert got.tobytes() == want.tobytes()


def test_normalize_iwe_and_color_wheel_equal_jax_bytes():
    rng = np.random.default_rng(1)
    iwes = rng.gamma(1.0, 3.0, (3, 20, 28)).astype(np.float32)
    iwes[1] = 2.5                      # a constant image
    for invert in (False, True):
        assert (tvis.normalize_iwe(iwes, invert).tobytes()
                == jvis.normalize_iwe(iwes, invert).tobytes())
    for size in (64, 256):
        assert tvis.color_wheel(size).tobytes() == jvis.color_wheel(
            size).tobytes()


def test_png8_writer_reads_back(tmp_path):
    from PIL import Image

    img = np.random.default_rng(2).integers(0, 256, (17, 23, 3),
                                            dtype=np.uint8)
    write_png8_rgb(tmp_path / "a.png", img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")),
                                  img)
    np.testing.assert_array_equal(read_png_rgb(tmp_path / "a.png"), img)
    with pytest.raises(ValueError, match="uint8"):
        write_png8_rgb(tmp_path / "b.png", img.astype(np.uint16))


def test_panel_logger_writes_jax_names(tmp_path):
    rng = np.random.default_rng(3)
    images = {"unwarped_iwe": rng.gamma(1.0, 2.0, (16, 20)),
              "gt_iwe": rng.gamma(1.0, 2.0, (16, 20)),
              "pred_iwe": rng.gamma(1.0, 2.0, (16, 20)),
              "gt_flow": rng.normal(0, 2, (2, 16, 20)),
              "pred_flow": rng.normal(0, 2, (2, 16, 20))}
    for index in (0, 3):
        jil.ImagePanelLogger(str(tmp_path / "jax")).log_panel(
            12, "val/", index, **images)
        til.ImagePanelLogger(str(tmp_path / "port")).log_panel(
            12, "val/", index, **images)
    want = sorted(p.name for p in (tmp_path / "jax" / "images").iterdir())
    got = sorted(p.name for p in (tmp_path / "port" / "images").iterdir())
    assert got == want and len(got) == 10
    assert "000012_03_val_4_flow.png" in got
    from PIL import Image

    for name in got:
        np.testing.assert_array_equal(
            read_png_rgb(tmp_path / "port" / "images" / name),
            np.asarray(Image.open(tmp_path / "jax" / "images" / name)))


@pytest.mark.parametrize("case", ["jax-test-batch", "cli-batch"])
def test_render_matches_jax(jstate, case):  # noqa: F811
    """jax-test-batch: the JAX image-logging test's kind of batch (events in
    any order, no polarity packing, a host voxel grid); cli-batch: the
    loader's (polarity-packed, LUT-cell-sorted), voxelized in the render."""
    jcfg, tcfg = configs()
    pab = case == "cli-batch"
    kw = {**LOSS_KW, "polarity_aware_batching": pab}
    jloss, tloss = JaxFocusCfg(**kw), FocusLossConfig(**kw)
    batch = make_batch(21, b=1, gt=True)
    if pab:
        del batch["voxel"]
    else:
        ev = batch["events"]
        batch = {"events": ev[:, np.random.default_rng(4).permutation(
            ev.shape[1])], "voxel": batch["voxel"],
            "forward_flow": batch["forward_flow"]}
    want = jloop.make_flow_render_fn(jstate, jcfg, jloss)(batch)
    state = port_state(tcfg, jstate)
    render = tloop.make_flow_render_fn(
        state, tloss, times=torch.tensor(np.asarray(jax_times(
            jloss, jax.random.PRNGKey(0)))))
    got = render(batch)
    assert set(got) == set(want) == set(PANEL)
    for key in PANEL:
        w = np.asarray(want[key])
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=key)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_render_leaves_the_model_mode(jstate, mode):  # noqa: F811
    _, tcfg = configs()
    state = port_state(tcfg, jstate)
    state.model.train(mode == "train")
    before = {n: m.training for n, m in state.model.named_modules()}
    stats = {k: v.clone() for k, v in state.model.state_dict().items()}
    render = tloop.make_flow_render_fn(state, FocusLossConfig(**LOSS_KW))
    out = render(make_batch(22, b=1, gt=True))
    assert {n: m.training for n, m in state.model.named_modules()} == before
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, stats[k]), k   # no BatchNorm update
    assert all(np.isfinite(v).all() for v in out.values())


def test_scalar_logger_tensorboard_mirror_equals_jsonl(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    logger = tloop.ScalarLogger(str(tmp_path))
    assert logger.tb is not None
    logger.log(1, {"train_losses/total": 0.5, "steps_per_s": 3.25})
    logger.log(2, {"train_losses/total": np.float32(0.25)})
    logger.log(2, {"val_losses/EPE": 1.75})
    til.ImagePanelLogger(str(tmp_path), tb_writer=logger.tb).log_panel(
        2, "val/", 0, gt_flow=np.ones((2, 8, 10), np.float32))
    logger.close()
    recs = [json.loads(line) for line in
            (tmp_path / "scalars.jsonl").read_text().splitlines()]
    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    want = {}
    for rec in recs:
        for key, val in rec.items():
            if key != "step":
                want.setdefault(key, []).append((rec["step"], val))
    assert sorted(acc.Tags()["scalars"]) == sorted(want)
    for key, pts in want.items():
        got = [(e.step, e.value) for e in acc.Scalars(key)]
        assert got == [(s, pytest.approx(v, rel=1e-7)) for s, v in pts], key
    assert acc.Tags()["images"] == ["00_val_3_gt_flow"]


def test_scalar_logger_without_tensorboard(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logger = tloop.ScalarLogger(str(tmp_path))
    logger.log(1, {"a": 1.0})
    logger.close()
    assert logger.tb is None and not (tmp_path / "tb").exists()
    assert json.loads((tmp_path / "scalars.jsonl").read_text()) == {
        "step": 1, "a": 1.0}

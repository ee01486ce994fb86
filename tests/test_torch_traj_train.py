"""Port's traj-train CLI and its data: the EVIMO2 train split and the
MultiFlow reader and augmentors against the JAX package's on the same
synthetic files and draws; `traj-train --device cpu` self-supervised on a
synthetic EVIMO2 tree and supervised on a synthetic MultiFlow tree (built
as tests/test_raft_training.py and tests/test_multiflow.py build them);
`traj-val` on MultiFlow.

The CLI runs with the Tab2L5 / MultiFlow experiment configs, cut by
overrides to one iteration, Bezier degree 2, batch 1 and a 16-pixel loss
superpixel, at MultiFlow's 384 x 512 and on EVIMO2 samples resized to
test_torch_traj_val.CLI_HW instead of 384 x 512, so that it runs in
seconds on the CPU.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from motionpriorcmax_tpu_torch.cli.main import main
from tests.test_multiflow import make_synthetic_multiflow
from tests.test_raft_training import make_synthetic_evimo2
from tests.test_torch_traj_val import small_evimo2
from tests._one_thread import one_torch_thread  # noqa: F401

FAST = ["training.batch_size=1", "model.num_iter.train=1",
        "model.num_iter.test=1", "model.bezier_degree=2"]


def _same_sample(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        elif k == "dataset_type":
            assert got[k].name == want[k].name
        elif k == "img":
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(a, b)
        else:
            assert got[k] == want[k], k


@pytest.fixture(scope="module")
def evimo2_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("evimo2") / "data"
    make_synthetic_evimo2(root, n_flows=2)
    shutil.copytree(root / "imo/eval/seq_a", root / "imo/train/seq_t")
    return root


@pytest.fixture(scope="module")
def multiflow_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("multiflow") / "mf"
    make_synthetic_multiflow(root, split="train")
    make_synthetic_multiflow(root, split="test")
    return root


@pytest.mark.filterwarnings("ignore")
def test_evimo2_train_split_matches_jax(evimo2_tree):
    from motionpriorcmax_tpu.data.evimo2 import Evimo2Datasubset
    from motionpriorcmax_tpu_torch.data.evimo2 import Evimo2Provider

    port = Evimo2Provider(evimo2_tree, 41, 300, True, 50,
                          provide_raw_events=True,
                          polarity_aware_batching=True, split="train")
    jax_sub = Evimo2Datasubset(evimo2_tree / "imo/train/seq_t", 41, 300, True,
                               provide_raw_events=True,
                               polarity_aware_batching=True,
                               flow_every_n_ms=50)
    assert len(port) == len(jax_sub) >= 1
    got, want = port[0], jax_sub[0]
    _same_sample(got, want)
    assert "pos_events" in got and "events" not in got


def test_multiflow_reader_and_augmentor_match_jax(multiflow_tree):
    from motionpriorcmax_tpu.data import augment as jaug
    from motionpriorcmax_tpu.data.multiflow import \
        MultiflowDatasubset as JaxSubset
    from motionpriorcmax_tpu_torch.data import augment as taug
    from motionpriorcmax_tpu_torch.data.multiflow import MultiflowDatasubset

    kw = dict(num_bins_context=6, flow_every_n_ms=100, load_voxel_grid=False,
              normalize_voxel_grid=True, provide_raw_events=True,
              polarity_aware_batching=True)
    for aug in (False, True):
        def make(mod):
            return mod.MultiflowAugmentor(
                spatial=mod.SpatialAugmentor(h_flip_prob=0.5, v_flip_prob=0.5,
                                             crop_hw=(256, 384), seed=3),
                photometric=mod.PhotometricAugmentor(seed=4)) if aug else None
        port = MultiflowDatasubset(multiflow_tree / "train",
                                   augmentor=make(taug), **kw)
        ref = JaxSubset(multiflow_tree / "train", augmentor=make(jaug), **kw)
        for _ in range(3 if aug else 1):     # successive draws agree too
            _same_sample(port[0], ref[0])


@pytest.fixture(scope="module")
def selfsup_run(evimo2_tree, tmp_path_factory):
    """One self-supervised traj-train CLI step with a validation pass, on
    the EVIMO2 samples cut to test_torch_traj_val.CLI_HW; its workdir."""
    workdir = tmp_path_factory.mktemp("selfsup") / "run"
    with pytest.MonkeyPatch.context() as mp:
        small_evimo2(mp)
        rc = main(["traj-train", "--device", "cpu",
                   "--config-dir", "config/trajectory_inference",
                   "--workdir", str(workdir), "--max-steps", "1",
                   "--log-every", "1", "--event-capacity", "4096",
                   "--val-every", "1", "--val-batch-size", "2",
                   "experiment=raft-spline_evimo2-300ms_ours-selfsup",
                   "checkpoint=/unused", f"dataset.path={evimo2_tree}",
                   "loss.lut_superpixel_size=16", "loss.num_knn=4", *FAST])
    assert rc == 0
    return workdir


def test_traj_train_selfsup_cli_on_cpu(selfsup_run):
    from motionpriorcmax_tpu_torch.models.raft_spline import RAFTSplineConfig
    from motionpriorcmax_tpu_torch.training.checkpoint import \
        restore_checkpoint
    from motionpriorcmax_tpu_torch.training.raft_spline import (
        RAFTTrainConfig, create_raft_train_state)

    workdir = selfsup_run
    recs = [json.loads(line) for line in
            (workdir / "scalars.jsonl").read_text().splitlines()]
    losses = [r["train_losses/total"] for r in recs
              if "train_losses/total" in r]
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert any("val/masked_TEPE" in r for r in recs)
    assert any("val/masked_TEPE_at_best" in r for r in recs)
    index = json.loads((workdir / "checkpoints/index.json").read_text())
    assert [e["step"] for e in index] == [1] and index[0]["metric"] is not None

    cfg = RAFTSplineConfig(bezier_degree=2, iters=1)
    state = create_raft_train_state(cfg, RAFTTrainConfig(total_steps=1),
                                    "cpu", torch.Generator().manual_seed(9))
    state, step = restore_checkpoint(str(workdir / "checkpoints"), state,
                                     best=True)
    assert step == 1 and state.scheduler.last_epoch == 1


@pytest.mark.parametrize("where", ["workdir", "checkpoints"])
def test_traj_val_restores_traj_train_checkpoint_dir(selfsup_run, evimo2_tree,
                                                     where, capsys,
                                                     monkeypatch):
    # traj-val on traj-train's output restores its latest step: the metrics
    # of traj-train's own validation pass with the in-memory model, on the
    # same eval split (cut to the same geometry) and batch size, up to
    # traj-val's 5-decimal print.
    small_evimo2(monkeypatch)
    ckpt = selfsup_run if where == "workdir" else selfsup_run / "checkpoints"
    recs = [json.loads(line) for line in
            (selfsup_run / "scalars.jsonl").read_text().splitlines()]
    want = next(r for r in recs if "val/masked_TEPE" in r)
    capsys.readouterr()
    assert main(["traj-val", "--device", "cpu",
                 "--config-dir", "config/trajectory_inference",
                 "experiment=raft-spline_evimo2-300ms_ours-selfsup",
                 f"checkpoint={ckpt}", f"dataset.path={evimo2_tree}",
                 "batch_size=2", "model.num_iter.test=1",
                 "model.bezier_degree=2"]) == 0
    out = capsys.readouterr().out
    got = {k: float(v) for k, v in (line.split(": ") for line in
                                    out.splitlines() if ": " in line)}
    keys = [k for k in want if k.startswith("val/")]
    assert keys and set(keys) <= set(got)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=5e-6,
                                   err_msg=k)


def test_traj_val_refuses_a_directory_without_checkpoints(tmp_path):
    # An empty directory is no checkpoint: refused, never random weights.
    (tmp_path / "run" / "checkpoints").mkdir(parents=True)
    with pytest.raises(SystemExit, match="step_"):
        main(["traj-val", "--device", "cpu",
              "--config-dir", "config/trajectory_inference",
              "experiment=raft-spline_evimo2-300ms_ours-selfsup",
              f"checkpoint={tmp_path / 'run'}",
              f"dataset.path={tmp_path}"])


def test_traj_train_supervised_cli_on_cpu(multiflow_tree, tmp_path):
    workdir = tmp_path / "run"
    rc = main(["traj-train", "--device", "cpu",
               "--config-dir", "config/trajectory_inference",
               "--workdir", str(workdir), "--max-steps", "1",
               "--log-every", "1", "--ckpt-every", "1", "--val-every", "0",
               "--loss", "supervised",
               "experiment=raft-spline_multiflow-500ms_supervised",
               "checkpoint=/unused", f"dataset.path={multiflow_tree}",
               "model.num_bins.context=6", "model.num_bins.correlation=4",
               "model.correlation.ev.target_indices=[2,4]",
               "model.correlation.ev.levels=[1,2]", *FAST])
    assert rc == 0
    rec = json.loads((workdir / "scalars.jsonl").read_text().splitlines()[0])
    assert np.isfinite(rec["train_losses/l1_final"])
    assert (workdir / "checkpoints/step_1.pt").is_file()


def test_traj_val_on_multiflow(multiflow_tree, tmp_path, capsys):
    from motionpriorcmax_tpu_torch.models.raft_spline import RAFTSplineConfig
    from tests.test_torch_traj_val import _port_ckpt

    ckpt = tmp_path / "mf.ckpt"
    _port_ckpt(ckpt, RAFTSplineConfig(
        bezier_degree=2, iters=1, nbins_context=41, nbins_correlation=25,
        ev_target_indices=(20, 40), ev_levels=(1, 2),
        use_boundary_images=True))
    assert main(["traj-val", "--device", "cpu",
                 "--config-dir", "config/trajectory_inference",
                 f"checkpoint={ckpt}", "dataset=multiflow_500ms",
                 f"dataset.path={multiflow_tree}",
                 "dataset.load_voxel_grid=false", "batch_size=1",
                 "model.num_iter.test=1", "model.bezier_degree=2",
                 "model.num_bins.correlation=25",
                 "model.correlation.ev.target_indices=[20, 40]",
                 "model.correlation.ev.levels=[1, 2]",
                 "model.use_boundary_images=true"]) == 0
    out = capsys.readouterr().out
    lines = dict(line.split(": ") for line in out.splitlines() if ": " in line)
    assert "val/ev_masked_TEPE" in lines and "val/EPE_STEP04" in lines
    assert all(np.isfinite(float(v)) for v in lines.values())


@pytest.mark.parametrize("extra,match", [
    ([], "is_available"),
    (["--device", "cpu", "--loss", "supervised"], "multiflow"),
])
def test_traj_train_refusals(tmp_path, monkeypatch, extra, match):
    # No CUDA without --device cpu (never a silent CPU run), and the
    # supervised loss needs MultiFlow's GT.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match=match):
        main(["traj-train", *extra,
              "--config-dir", "config/trajectory_inference",
              "experiment=raft-spline_evimo2-300ms_ours-selfsup",
              "checkpoint=/unused", f"dataset.path={tmp_path}"])

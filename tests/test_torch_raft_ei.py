"""RAFT-Spline over events and boundary frames ("E+I") with the supervised
MultiFlow step, against the plain reference (perfbench/reference/
raft_ei.py) on the CPU at tiny widths, with the same seeded weights loaded
by name into both; and `traj-train --loss supervised` with
`model.use_boundary_images=true` through the CLI on a synthetic MultiFlow
tree, then `traj-val` on its checkpoint with the same overrides.

Tolerances: both sides compute in f32 on the CPU, with other convolution
algorithms, another lookup (the reference gathers whole windows, the port
runs the kernel's plain version) and other summation orders, through
three recurrent iterations: 1e-5 of the largest value (losses, every
iteration's parameters and masks) and 1e-4 of each leaf's gradient norm
cover that rounding and are ten to a hundred times below what a changed
term moves (a frame normalized otherwise, the frame target looked up at
another time, one iteration's weight).  AdamW's first update divides each
element's gradient by its own magnitude, so it is held by its norm per
leaf, to 1e-3 (1.3e-4 measured).
"""

import json
import math

import numpy as np
import pytest
import torch

from motionpriorcmax_tpu_torch.cli.main import main
from motionpriorcmax_tpu_torch.data.collate import stack_samples
from motionpriorcmax_tpu_torch.models.raft_spline import (RAFTSpline,
                                                          RAFTSplineConfig)
from motionpriorcmax_tpu_torch.training import loop
from motionpriorcmax_tpu_torch.training import raft_spline as trs
from motionpriorcmax_tpu_torch.training.loop import to_device
from perfbench.generators.common import load_weights, seeded_weights
from perfbench.reference.optim import AdamW
from perfbench.reference.raft_ei import RAFTSplineEI, supervised_step
from tests._one_thread import one_torch_thread  # noqa: F401
from tests.test_multiflow import make_synthetic_multiflow

H, W, B, ITERS, GT = 32, 32, 2, 3, 4
TINY = dict(nbins_context=6, nbins_correlation=4, degree=2,
            target_indices=(2, 5), levels=(1, 2), img_levels=2, hidden=16,
            context=16, feature=32, motion=24, iters=ITERS)
PORT = RAFTSplineConfig(
    nbins_context=6, nbins_correlation=4, bezier_degree=2,
    ev_target_indices=(2, 5), ev_levels=(1, 2), img_levels=2,
    use_boundary_images=True, hidden_dim=16, context_dim=16, feature_dim=32,
    motion_dim=24, iters=ITERS)
LR, WD = 1e-3, 1e-4


def batch(seed=3):
    rng = np.random.default_rng(seed)
    samples = [{"ev_repr": rng.normal(size=(9, H, W)).astype(np.float32),
                "flow": 3 * rng.normal(size=(GT, 2, H, W)).astype(np.float32),
                "flow_timestamps": np.linspace(0, 1, GT + 1)[1:].astype(
                    np.float32),
                "img": rng.integers(0, 256, (2, 3, H, W)).astype(np.float32)}
               for _ in range(B)]
    return to_device(stack_samples(samples), "cpu")


@pytest.fixture(scope="module")
def models():
    ref = RAFTSplineEI(**TINY).train()
    weights = seeded_weights([(k, tuple(p.shape))
                              for k, p in ref.named_parameters()], 2**33 + 5,
                             "cpu")
    load_weights(ref, weights)
    port = RAFTSpline(PORT).train()
    assert ({k for k, _ in port.named_parameters()}
            == {k for k, _ in ref.named_parameters()})
    load_weights(port, weights)
    return port, ref, weights


def close(got, want, tol):
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= tol * scale


def test_every_iteration_matches_the_reference(models):
    port, ref, _ = models
    b = batch()
    with torch.no_grad():
        p_seq, m_seq = port(b["ev_repr"], b["img"].unbind(1),
                            return_sequences=True)
        r_p, r_m = ref(b["ev_repr"], (b["img"][:, 0], b["img"][:, 1]),
                       keep_all=True)
    assert p_seq.shape[0] == len(r_p) == ITERS
    for i in range(ITERS):
        close(p_seq[i], r_p[i], 1e-5)
        close(m_seq[i], r_m[i], 1e-5)
    # The frames matter: without them the reference's answer moves far.
    with torch.no_grad():
        r_zero, _ = ref(b["ev_repr"], (torch.zeros_like(b["img"][:, 0]),) * 2,
                        keep_all=True)
    assert float((r_zero[-1] - r_p[-1]).abs().max()) > 1e-3 * float(
        r_p[-1].abs().max())


def test_supervised_step_loss_gradients_and_update(models):
    _, ref, weights = models
    port = RAFTSpline(PORT)
    load_weights(port, weights)
    opt, _ = trs.make_optimizer(port, trs.RAFTTrainConfig(
        learning_rate=LR, weight_decay=WD, use_scheduler=False))
    state = trs.RAFTTrainState(model=port, optimizer=opt, scheduler=None,
                               tc=trs.RAFTTrainConfig(use_scheduler=False))
    ref = RAFTSplineEI(**TINY).train()
    load_weights(ref, weights)
    params = dict(ref.named_parameters())
    b = batch(4)
    logs = trs.raft_supervised_train_step(state, b, gamma=0.8)
    loss, grads = supervised_step(ref, params, b, 0.8)
    assert math.isclose(float(logs["train_losses/total"]),
                        float(loss.detach()), rel_tol=1e-5)
    port_grads = {k: p.grad for k, p in port.named_parameters()}
    norms = {k: float(g.norm()) for k, g in grads.items()}
    med = float(np.median(list(norms.values())))
    # A convolution's bias before an instance norm has no gradient but
    # round-off (the norm takes the mean out): such leaves, under a
    # thousandth of the median leaf's, are held to the median's scale and
    # left out of the update, which Adam scales up to the rate whatever
    # their sign, as the benchmark's comparison leaves them out.
    moved = {k for k, n in norms.items() if n >= 1e-3 * med}
    assert {k for k in moved if k.startswith("fnet_img.")}
    for k, g in grads.items():
        gap = float((port_grads[k] - g).norm())
        assert gap <= 1e-4 * max(norms[k], med), k
    # Adam's first update is lr g / (|g| + eps) per element: elements whose
    # gradient is near eps turn rounding into a change of up to the rate,
    # so the update is held by its norm per leaf.
    AdamW(params, LR, WD).step(grads)
    worst = 0.0
    for k, p in port.named_parameters():
        if k in moved:
            want = params[k].detach() - weights[k]
            gap = float((p.detach() - weights[k] - want).norm())
            worst = max(worst, gap / float(want.norm()))
    assert worst <= 1e-3


@pytest.fixture(scope="module")
def multiflow_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("multiflow_ei") / "mf"
    make_synthetic_multiflow(root, split="train")
    make_synthetic_multiflow(root, split="test")
    return root


MODEL = ["model.use_boundary_images=true", "model.num_bins.context=6",
         "model.num_bins.correlation=4", "model.bezier_degree=2",
         "model.correlation.ev.target_indices=[2,4]",
         "model.correlation.ev.levels=[1,2]", "model.correlation.img.levels=2"]


def test_traj_train_supervised_with_frames_then_traj_val(
        multiflow_tree, tmp_path, monkeypatch, capsys):
    seen = []
    step = loop.raft_supervised_train_step

    def spy(state, b, *args, **kw):
        seen.append(tuple(b["img"].shape))
        return step(state, b, *args, **kw)

    monkeypatch.setattr(loop, "raft_supervised_train_step", spy)
    workdir = tmp_path / "run"
    assert main(["traj-train", "--device", "cpu",
                 "--config-dir", "config/trajectory_inference",
                 "--workdir", str(workdir), "--max-steps", "1",
                 "--log-every", "1", "--ckpt-every", "1", "--val-every", "0",
                 "--loss", "supervised",
                 "experiment=raft-spline_multiflow-500ms_supervised",
                 "checkpoint=/unused", f"dataset.path={multiflow_tree}",
                 "training.batch_size=1", "model.num_iter.train=1",
                 "model.num_iter.test=1", *MODEL]) == 0
    assert seen == [(1, 2, 3, 384, 512)]
    rec = json.loads((workdir / "scalars.jsonl").read_text().splitlines()[0])
    assert np.isfinite(rec["train_losses/l1_final"])
    capsys.readouterr()
    assert main(["traj-val", "--device", "cpu",
                 "--config-dir", "config/trajectory_inference",
                 f"checkpoint={workdir}", "dataset=multiflow_500ms",
                 f"dataset.path={multiflow_tree}", "batch_size=1",
                 "model.num_iter.test=1", *MODEL]) == 0
    out = capsys.readouterr().out
    lines = dict(line.split(": ") for line in out.splitlines() if ": " in line)
    assert "val/ev_masked_TEPE" in lines
    assert all(np.isfinite(float(v)) for v in lines.values())

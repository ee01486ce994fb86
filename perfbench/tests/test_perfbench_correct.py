"""`correct` on the CPU at a tiny size: each traffic mix's port entry
agrees with the reference, the control (the reference one precision step
below the configuration's, in the program's place) fails the cell's
limits, and a run with the timed path broken underneath comes out not
correct: a step that returns its state unchanged, half of the batch left
out (the mean over the rest), an answer altered where it is produced.
(One chip per cell: there is no exchange between chips to leave out.)"""

import pytest
import torch

from perfbench import control
from perfbench.tests.tiny import run_tiny, tiny_cell

TRAIN = ["dsec-unet.train-softmax", "dsec-unet.train-exact",
         "raft-tab2l5.train-exact"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", TRAIN)
def test_training_step_agrees_with_the_reference(name):
    # The bf16 UNet rounds its input: a voxel grid summed in another order
    # (the host's, in the exact cell) flips roundings, which moves the
    # first gradient of the small leaves (norms) by up to ~10% at this
    # size, while the losses agree to f32 rounding.
    res = run_tiny(name)
    got = dict(res["details"])
    got.update({k: c["value"] for k, c in res["compared"].items()})
    assert got["loss_gap"] < 1e-4
    assert got["grad_gap"] < 0.25
    assert res["attempted"] >= 1


def test_evaluation_request_agrees_with_the_reference():
    res = run_tiny("raft-tab2l5.eval-b8")
    assert res["compared"]["params_gap"]["value"] < 1e-5
    assert res["compared"]["epe_gap"]["value"] < 1e-5
    assert res["details"]["compared"] >= 1


@pytest.mark.parametrize("name", ["dsec-unet.train-softmax",
                                  "dsec-unet.train-exact"])
def test_fp8_control_fails(name):
    _, _, config, traffic, limits = tiny_cell(name)
    nums = control.control_numbers(config, traffic, 98765, "cpu")
    assert any(nums[k] > v for k, v in limits.items()), nums


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["raft-tab2l5.train-exact",
                                  "raft-tab2l5.eval-b8"])
def test_tf32_control_fails(name):
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists on the card only")
    _, _, config, traffic, limits = tiny_cell(name)
    nums = control.control_numbers(config, traffic, 98765, "cuda")
    assert any(nums[k] > v for k, v in limits.items()), nums


def _params_of(state):
    model = getattr(state, "model")
    return [p for p in model.parameters()]


def _state_unchanged(step):
    def broken(state, *args, **kw):
        before = [p.detach().clone() for p in _params_of(state)]
        logs = step(state, *args, **kw)
        with torch.no_grad():
            for p, b in zip(_params_of(state), before):
                p.copy_(b)
        return logs
    return broken


def _half_batch(step):
    def broken(state, batch, *args, **kw):
        half = {k: (v[: v.shape[0] // 2] if torch.is_tensor(v) else v)
                for k, v in batch.items()}
        return step(state, half, *args, **kw)
    return broken


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_broken_training_step_is_not_correct(name, fault, monkeypatch):
    from motionpriorcmax_tpu_torch.training import raft_spline, trajectory_net

    module, attr = ((trajectory_net, "train_step") if name.startswith("dsec")
                    else (raft_spline, "raft_train_step"))
    wrap = _state_unchanged if fault == "state_unchanged" else _half_batch
    monkeypatch.setattr(module, attr, wrap(getattr(module, attr)))
    res = run_tiny(name)
    assert res["correct"] is False, res["compared"]


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch"])
def test_broken_request_is_not_correct(fault, monkeypatch):
    from motionpriorcmax_tpu_torch.models.raft_spline import raft
    from motionpriorcmax_tpu_torch.training import raft_spline

    if fault == "answer_altered":
        orig = raft.cvx_upsample

        def altered(data, mask):
            up = orig(data, mask)
            return torch.cat([up[:1] * 1.1, up[1:]])

        monkeypatch.setattr(raft, "cvx_upsample", altered)
    else:
        monkeypatch.setattr(raft_spline, "raft_validation_step",
                            _half_batch(raft_spline.raft_validation_step))
    res = run_tiny("raft-tab2l5.eval-b8")
    assert res["correct"] is False, res["compared"]

"""The RAFT-Spline E+I cell and the softmax Tab2L5 cell on the CPU at a
tiny size, run through `harness.run_cell`: each agrees with the reference
and reports its metrics; a fault planted in the supervised step (the
frames fed as zeros, half the batch) and the TF32 control (on the card)
come out not correct.  And the two readers this cell brought, on
synthetic records."""

import pytest
import torch

from perfbench import control, harness, trace
from perfbench.metrics import _program
from perfbench.tests.tiny import tiny_cell

EI = "raft-ei-multiflow500.train-supervised"
SOFTMAX = "raft-tab2l5.train-softmax"


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(monkeypatch):
    """harness.run_cell on the tiny configuration and traffic of a cell."""
    files = {name: tiny_cell(name)[2:] for name in (EI, SOFTMAX)}
    monkeypatch.setattr(harness, "cell_files",
                        lambda bench, cell: files[cell["name"]])

    def run(name, traced=False):
        # Traced, the window has to outlast the first step, after which
        # the stretch starts.
        bench = harness.load_benchmark()
        return harness.run_cell(bench, harness.find_cell(bench, name),
                                2**31 + 11, 3.0 if traced else 0.3, traced,
                                "cpu")
    return run


@pytest.mark.parametrize("name", [EI, SOFTMAX])
def test_cell_agrees_with_the_reference_and_reports(tiny, name):
    res = tiny(name)
    assert res["correct"] is True, res["compared"]
    assert set(res["compared"]) == {"loss_gap", "grad_gap", "update_gap"}
    assert sorted(res["metrics"]) == ["setup_s", "train_samples_per_s"]
    traced = tiny(name, traced=True)
    # No CUDA here: the device_trace and span readers find nothing to
    # read but the share of the peak, which the stretch's clock gives.
    assert "mfu.train" in traced["metrics"]


def _planted(fault):
    from motionpriorcmax_tpu_torch.training import raft_spline

    step = raft_spline.raft_supervised_train_step

    def broken(state, batch, *args, **kw):
        if fault == "zero_frames":
            batch = dict(batch, img=torch.zeros_like(batch["img"]))
        else:
            batch = {k: (v[: v.shape[0] // 2] if torch.is_tensor(v) else v)
                     for k, v in batch.items()}
        return step(state, batch, *args, **kw)
    return broken


@pytest.mark.parametrize("fault", ["zero_frames", "half_batch"])
def test_planted_fault_is_not_correct(tiny, monkeypatch, fault):
    from motionpriorcmax_tpu_torch.training import raft_spline

    monkeypatch.setattr(raft_spline, "raft_supervised_train_step",
                        _planted(fault))
    res = tiny(EI)
    assert res["correct"] is False, res["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [EI, SOFTMAX])
def test_tf32_control_fails(name):
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists on the card only")
    _, _, config, traffic, limits = tiny_cell(name)
    nums = control.control_numbers(config, traffic, 98765, "cuda")
    assert any(nums[k] > v for k, v in limits.items()), nums


# -- the readers ---------------------------------------------------------------

def _run(events):
    return {"kind": "train", "events": events, "stretch_us": (0.0, 10000.0),
            "stretch_steps": 2, "classes": trace.load_classes()}


def _ev(name, start, dur, device):
    return {"name": name, "device": device, "start_us": float(start),
            "dur_us": float(dur)}


def test_corr_window_ns(monkeypatch):
    counters = {"corr.windows": 3000, "steps.train": 6}
    monkeypatch.setattr(_program, "snapshot",
                        lambda: {"counters": counters, "spans": {}})
    events = [_ev("void corr_window_lookup_kernel<4>(Params)", 100, 3, True),
              _ev("corr_window_lookup_bwd_kernel", 200, 7, True),
              _ev("corr_window_lookup_kernel", 5000, 3, True),
              _ev("corr_window_lookup_bwd_kernel", 5100, 7, True),
              _ev("sm90_xmma_fprop_implicit_gemm_f32", 300, 900, True),
              _ev("corr_window_lookup", 0, 9000, False)]
    read = harness.read_metric
    # 10 us of the kernels per step over 500 windows per step.
    assert read({"name": "corr_window_ns.train"}, _run(events)) == \
        pytest.approx(20.0)
    assert read({"name": "corr_window_ns.eval"}, _run(events)) is None
    assert read({"name": "corr_window_ns.train"}, _run(events[4:])) is None
    counters.pop("corr.windows")       # a program without the counter
    assert read({"name": "corr_window_ns.train"}, _run(events)) is None


def test_image_encoder_ms(monkeypatch):
    spans = {"step.train": {"count": 2, "device_ms": 1500.0, "steps": [0, 1]},
             "model.encode_images": {"count": 2, "device_ms": 70.0,
                                     "steps": [0, 1]}}
    monkeypatch.setattr(_program, "snapshot",
                        lambda: {"counters": {}, "spans": spans})
    read = harness.read_metric
    assert read({"name": "image_encoder_ms.train"}, _run([])) == \
        pytest.approx(35.0)
    spans.pop("model.encode_images")   # events only: nothing to read
    assert read({"name": "image_encoder_ms.train"}, _run([])) is None

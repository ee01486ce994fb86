"""The readers of the program's spans and counters, on synthetic event
records and a synthetic snapshot of the program's registry (the form of
motionpriorcmax_tpu_torch/utils/profiling.py::snapshot)."""

import sys

import pytest

from perfbench import harness, trace
from perfbench.metrics import _program


class Registry:
    """Spans and counters as the program's registry holds them."""

    def __init__(self):
        self.spans, self.counters = {}, {}

    def add(self, name, ms, step):
        entry = self.spans.setdefault(name, {"count": 0, "device_ms": 0.0,
                                             "steps": []})
        entry["count"] += 1
        entry["steps"].append(step)
        if ms is None or entry["device_ms"] is None:
            entry["device_ms"] = None
        else:
            entry["device_ms"] += ms

    def snapshot(self):
        return {"counters": dict(self.counters), "spans": self.spans}


@pytest.fixture
def registry(monkeypatch):
    reg = Registry()
    monkeypatch.setattr(_program, "snapshot", reg.snapshot)
    return reg


def fill_train(reg, steps=2):
    for s in range(steps):
        for name, ms in (("step.optimizer", 0.5), ("model.forward", 10.0),
                         ("loss.forward", 3.0), ("loss.knn", 2.0),
                         ("loss.backward", 4.0), ("model.backward", 20.0),
                         ("step.optimizer", 1.5), ("step.train", 40.0)):
            reg.add(name, ms, s)


def ev(name, start, dur, device=False):
    return {"name": name, "device": device, "start_us": float(start),
            "dur_us": float(dur)}


def _run(kind="train", steps=2, events=()):
    return {"kind": kind, "events": list(events), "stretch_us": (0.0, 10000.0),
            "stretch_steps": steps, "classes": trace.load_classes()}


def _read(name, run):
    return harness.read_metric({"name": name}, run)


def test_span_readers_per_step(registry):
    fill_train(registry)
    run = _run()
    assert _read("model_ms.train", run) == pytest.approx(30.0)
    assert _read("loss_ms.train", run) == pytest.approx(7.0)
    assert _read("knn_ms.train", run) == pytest.approx(2.0)
    assert _read("optimizer_ms.train", run) == pytest.approx(2.0)


def test_span_readers_need_one_step_span_per_stretch_step(registry):
    fill_train(registry, steps=3)
    run = _run(steps=2)
    for name in ("model_ms.train", "loss_ms.train", "knn_ms.train",
                 "optimizer_ms.train"):
        assert _read(name, run) is None


def test_span_readers_leave_out_what_they_cannot_read(registry):
    fill_train(registry)
    assert _read("model_ms.eval", _run()) is None       # another kind
    untraced = {k: v for k, v in _run().items() if k != "events"}
    assert _read("model_ms.train", untraced) is None
    registry.spans.clear()
    for s in range(2):                                   # softmax: no KNN
        registry.add("model.forward", 1.0, s)
        registry.add("model.backward", 1.0, s)
        registry.add("step.train", 3.0, s)
    assert _read("knn_ms.train", _run()) is None
    assert _read("model_ms.train", _run()) == pytest.approx(2.0)
    # Spans recorded without CUDA events have no device ms.
    registry.spans.clear()
    for s in range(2):
        registry.add("step.train", None, s)
        registry.add("step.optimizer", None, s)
    assert _read("optimizer_ms.train", _run()) is None


def test_a_program_without_the_registry_gives_nothing(monkeypatch):
    # The parent of the change that added the registry: nothing raises.
    monkeypatch.setitem(sys.modules,
                        "motionpriorcmax_tpu_torch.utils.profiling", None)
    assert _program.snapshot() is None
    assert _read("model_ms.train", _run()) is None
    assert _read("h2d_pageable_mb.eval", _run("eval")) is None


def eval_events():
    # A 10 ms stretch of 2 requests.  Request 1: the stack 0-2 ms and the
    # copy 2-3 ms on the host, the copy's memcpy 2.2-3 ms, the step 3-5 ms
    # busy 3.5-5 ms.  Request 2: the stack 5-7 ms, the copy 7-8 ms (its
    # memcpy 7-8 ms), the step 8-10.5 ms, clipped to the stretch.
    return [
        ev("batch.stack", 0, 2000), ev("batch.h2d", 2000, 1000),
        ev("Memcpy HtoD (Pageable -> Device)", 2200, 800, True),
        ev("step.eval", 3000, 2000),
        ev("sm90_xmma_fprop_implicit_gemm_f32", 3500, 1500, True),
        ev("batch.stack", 5000, 2000), ev("batch.h2d", 7000, 1000),
        ev("Memcpy HtoD (Pageable -> Device)", 7000, 1000, True),
        ev("step.eval", 8000, 2500),
        ev("sm90_xmma_fprop_implicit_gemm_f32", 8000, 2000, True),
    ]


def test_batch_host_ms_and_loop_idle_share():
    run = _run("eval", events=eval_events())
    assert _read("batch_host_ms.eval", run) == pytest.approx(3.0)
    # Idle while in a batch span: 0-2.2 ms and 5-7 ms.
    assert _read("loop_idle_share.eval", run) == pytest.approx(42.0)
    # Idle in all: those and 3-3.5 ms.
    assert _read("idle_share.eval", run) == pytest.approx(47.0)


def test_host_span_readers_need_one_step_span_per_stretch_step():
    events = [e for e in eval_events() if e["start_us"] != 8000.0
              or e["device"]]
    run = _run("eval", events=events)
    assert _read("batch_host_ms.eval", run) is None
    assert _read("loop_idle_share.eval", run) is None
    assert _read("batch_host_ms.eval", _run("train", events=eval_events())
                 ) is None


def test_h2d_pageable_mb_per_request(registry):
    registry.counters.update({"h2d.pageable_bytes": 4 * 493_879_296,
                              "h2d.pinned_bytes": 1000, "requests.eval": 4})
    assert _read("h2d_pageable_mb.eval", _run("eval")) == pytest.approx(
        493.879296)
    assert _read("h2d_pageable_mb.eval", _run("train")) is None
    registry.counters.clear()
    assert _read("h2d_pageable_mb.eval", _run("eval")) is None

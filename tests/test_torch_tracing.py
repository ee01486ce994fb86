"""The port's spans and counters (utils/profiling.py) on the CPU, and one
profiled flow step on the card.

  * each entry point the benchmark drives (the flow train_step with the
    host or the device voxel grid, raft_train_step with and without gamma,
    raft_supervised_train_step with and without boundary frames,
    raft_validation_step after stack_traj_batch, to_device) opens the
    documented spans under torch.profiler, each nested in its documented
    parent, and the registry counts them with the step they belong to;
  * no program span is a user annotation (the profiler would mirror one
    onto the device's timeline);
  * with the profiler off a span makes one check and creates no
    RecordFunction, and the registry's span totals stay empty;
  * the backward split fires once per step, after the loss's backward ops
    and before the model's;
  * the counters: host-to-device bytes of a known batch, the correlation
    windows of a known model, the wrappers' `.launches` in the snapshot,
    reset.

No JAX here: the card test runs with `--noconftest` on the GPU machine.
"""

import math
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from motionpriorcmax_tpu_torch.cli.main import stack_traj_batch
from motionpriorcmax_tpu_torch.data.collate import (collate_fixed_capacity,
                                                    stack_samples)
from motionpriorcmax_tpu_torch.data.host_ops import voxelize_normalized_host
from motionpriorcmax_tpu_torch.losses import FocusLossConfig
from motionpriorcmax_tpu_torch.models.raft_spline import RAFTSplineConfig
from motionpriorcmax_tpu_torch.ops.cuda import iwe_vote
from motionpriorcmax_tpu_torch.training import raft_spline as trs
from motionpriorcmax_tpu_torch.training import trajectory_net as ttn
from motionpriorcmax_tpu_torch.training.loop import to_device
from motionpriorcmax_tpu_torch.utils import profiling

FH, FW, NB = 32, 48, 15
WIDTHS = (8, 16, 16, 32, 32)
RH, RW = 32, 32
RAFT = dict(nbins_context=5, nbins_correlation=3, bezier_degree=2,
            ev_target_indices=(2, 4), ev_levels=(1, 2), iters=2)
RAFT_LOSS = dict(image_shape=(RH, RW), num_bins=5, num_knn=4)
SPANS = ("batch.stack", "batch.h2d", "batch.to_device", "step.train",
         "step.eval", "step.voxelize", "step.optimizer", "step.backward",
         "model.forward", "model.encode", "model.encode_images",
         "model.corr_pyramid",
         "model.update", "model.backward", "loss.forward", "loss.interpolate",
         "loss.knn", "loss.warp", "loss.vote", "loss.objective",
         "loss.smooth", "loss.backward")
FOCUS = {"loss.interpolate": "loss.forward", "loss.warp": "loss.forward",
         "loss.vote": "loss.forward", "loss.objective": "loss.forward",
         "loss.smooth": "loss.forward"}
KNN = {"loss.knn": "loss.interpolate"}
RAFT_MODEL = {"model.encode": "model.forward",
              "model.corr_pyramid": "model.forward",
              "model.update": "model.forward"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """tests/_one_thread.py's fixture, inline: under --noconftest on the
    GPU machine `tests` may resolve to another installed package."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_registry(monkeypatch):
    """An empty registry; the wrappers' launch counts come back after."""
    for fn in profiling._launch_counted():
        monkeypatch.setattr(fn, "launches", fn.launches)
    profiling.reset()
    yield
    profiling.reset()


# -- inputs -------------------------------------------------------------------

def flow_events(rng, n, h=FH, w=FW):
    t = np.sort(rng.uniform(0, 1, n))
    return np.stack([rng.uniform(0, h, n), rng.uniform(0, w, n), t,
                     rng.integers(0, 2, n),
                     np.clip(np.searchsorted(np.linspace(0, 1, NB + 1), t) - 1,
                             0, None)], -1).astype(np.float32)


def flow_batch(seed, voxel=True, b=2, n=1500, capacity=2048):
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(b):
        ev = flow_events(rng, n)
        s = {"pos_events": ev[ev[:, 3] == 1], "neg_events": ev[ev[:, 3] == 0]}
        if voxel:
            s["voxel"] = voxelize_normalized_host(ev, NB, FH, FW)
        samples.append(s)
    return collate_fixed_capacity(samples, capacity, True,
                                  lut_cell_sort_params=((FH, FW), NB, 4))


def raft_batch(seed, b=2, n=1200, capacity=1536):
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(b):
        t = np.sort(rng.uniform(0, 1, n))
        ev = np.stack([rng.uniform(0, RH - 1, n), rng.uniform(0, RW - 1, n),
                       t, rng.integers(0, 2, n),
                       np.clip((t * 5).astype(np.int64), 0, 4)], -1
                      ).astype(np.float32)
        samples.append({"pos_events": ev[ev[:, 3] == 1],
                        "neg_events": ev[ev[:, 3] == 0],
                        "ev_repr": rng.normal(size=(7, RH, RW)).astype(
                            np.float32)})
    return collate_fixed_capacity(samples, capacity, True,
                                  lut_cell_sort_params=((RH, RW), 5, 4))


def traj_samples(seed, b=2, steps=3, h=RH, w=RW):
    rng = np.random.default_rng(seed)
    return [{"ev_repr": rng.normal(size=(7, h, w)).astype(np.float32),
             "flow": rng.normal(size=(steps, 2, h, w)).astype(np.float32),
             "flow_valid": rng.uniform(size=(steps, h, w)) > 0.2}
            for _ in range(b)]


# -- the entry points, each as the benchmark drives it -------------------------

def flow_step(device_voxel, device="cpu", steps=1):
    cfg = ttn.TrajectoryNetConfig(image_shape=(FH, FW), num_bins=NB,
                                  unet_widths=WIDTHS)
    state = ttn.create_train_state(cfg, device)
    loss_cfg = FocusLossConfig(image_shape=(FH, FW), num_bins=NB, num_knn=8,
                               knn_method="softmax" if device_voxel
                               else "exact")
    host = flow_batch(3, voxel=not device_voxel)
    gen = torch.Generator().manual_seed(0)

    def run():
        for _ in range(steps):
            batch = to_device(host, device)
            ttn.train_step(state, batch, gen, cfg, loss_cfg,
                           num_pos_events=int(host["num_pos_events"]))
    return run


def raft_step(gamma, steps=1):
    cfg = RAFTSplineConfig(**RAFT)
    tc = trs.RAFTTrainConfig(learning_rate=1e-4)
    state = trs.create_raft_train_state(cfg, tc, "cpu")
    loss_cfg = FocusLossConfig(**RAFT_LOSS)
    host = raft_batch(4)
    gen = torch.Generator().manual_seed(0)

    def run():
        for _ in range(steps):
            trs.raft_train_step(state, to_device(host, "cpu"), gen, loss_cfg,
                                num_pos_events=int(host["num_pos_events"]),
                                gamma=gamma)
    return run


def raft_supervised(images, steps=1):
    cfg = RAFTSplineConfig(**RAFT, use_boundary_images=images, img_levels=2)
    state = trs.create_raft_train_state(cfg, trs.RAFTTrainConfig(), "cpu")
    samples = traj_samples(9)
    rng = np.random.default_rng(10)
    for s in samples:
        del s["flow_valid"]
        s["flow_timestamps"] = np.float32([1 / 3, 2 / 3, 1.0])
        if images:
            s["img"] = rng.integers(0, 256, (2, 3, RH, RW)).astype(np.float32)
    host = stack_samples(samples)

    def run():
        for _ in range(steps):
            trs.raft_supervised_train_step(state, to_device(host, "cpu"))
    return run


def raft_eval():
    model = trs.create_raft_model(RAFTSplineConfig(**RAFT), "cpu")
    samples = traj_samples(5)

    def run():
        batch = stack_traj_batch(samples, torch.device("cpu"), False)
        trs.raft_validation_step(model, batch, (1 / 3, 2 / 3, 1.0))
    return run


def loader_only():
    host = flow_batch(6)

    def run():
        to_device(host, "cpu")
    return run


TRAIN = {"step.optimizer": "step.train", "model.forward": "step.train",
         "loss.forward": "step.train", "batch.to_device": None,
         "step.train": None}
SPLIT = {"loss.backward": "step.train", "model.backward": "step.train"}
CASES = {
    # case: (make the run, {span: its parent span, None at the top})
    "flow_host_voxel": (lambda: flow_step(False),
                        {**TRAIN, **SPLIT, **FOCUS, **KNN}),
    # softmax interpolation: no KNN
    "flow_device_voxel": (lambda: flow_step(True),
                          {**TRAIN, **SPLIT, **FOCUS,
                           "step.voxelize": "step.train"}),
    "raft_train": (lambda: raft_step(None),
                   {**TRAIN, **SPLIT, **FOCUS, **KNN, **RAFT_MODEL}),
    "raft_train_gamma": (lambda: raft_step(0.8),
                         {**TRAIN, **FOCUS, **KNN, **RAFT_MODEL,
                          "step.backward": "step.train"}),
    "raft_supervised": (lambda: raft_supervised(False),
                        {**TRAIN, **SPLIT, **RAFT_MODEL}),
    "raft_supervised_images": (lambda: raft_supervised(True),
                               {**TRAIN, **SPLIT, **RAFT_MODEL,
                                "model.encode_images": "model.encode"}),
    "raft_eval": (raft_eval, {"batch.stack": None, "batch.h2d": None,
                              "step.eval": None,
                              "model.forward": "step.eval", **RAFT_MODEL}),
    "to_device": (loader_only, {"batch.to_device": None}),
}


def program_events(prof):
    """(name, start_ns, end_ns, is_user_annotation) of every program span
    the profiler recorded on the host."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name() in SPANS and e.device_type().name == "CPU":
            out.append((e.name(), e.start_ns(),
                        e.start_ns() + e.duration_ns(),
                        e.is_user_annotation()))
    return out


def parent_of(event, events):
    """The innermost other program span that contains `event`."""
    _, a, b, _ = event
    around = [e for e in events if e is not event and e[1] <= a
              and b <= e[2] and (e[1], e[2]) != (a, b)]
    return min(around, key=lambda e: e[2] - e[1])[0] if around else None


@pytest.fixture(scope="module")
def profiled():
    """Each case run once under torch.profiler: (its program events, the
    registry's snapshot, the kineto events)."""
    out = {}
    for name, (make, _) in CASES.items():
        run = make()
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run()
        out[name] = (program_events(prof), profiling.snapshot(),
                     list(prof.profiler.kineto_results.events()))
    profiling.reset()
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_span_names_and_nesting(profiled, case):
    events, snap, _ = profiled[case]
    want = CASES[case][1]
    assert {e[0] for e in events} == set(want)
    for e in events:
        assert parent_of(e, events) == want[e[0]], e[0]
    # The registry saw the same spans, each of the one step (ordinal 0).
    counts = {}
    for e in events:
        counts[e[0]] = counts.get(e[0], 0) + 1
    assert {k: v["count"] for k, v in snap["spans"].items()} == counts
    for name, entry in snap["spans"].items():
        assert entry["steps"] == [0] * entry["count"], name
        assert entry["device_ms"] is None          # no CUDA: no events
    if case.startswith("raft"):
        assert counts["model.update"] == RAFT["iters"]


@pytest.mark.parametrize("case", list(CASES))
def test_program_spans_are_not_user_annotations(profiled, case):
    events, _, _ = profiled[case]
    assert events
    assert not any(user for *_, user in events)


def test_scope_off_makes_one_check_and_records_nothing(monkeypatch):
    made, checks = [], []
    real_range, real_enabled = (profiling._RecordFunctionFast,
                                profiling._profiler_enabled)

    def counting_range(name):
        made.append(name)
        return real_range(name)

    def counting_enabled():
        checks.append(1)
        return real_enabled()

    monkeypatch.setattr(profiling, "_RecordFunctionFast", counting_range)
    monkeypatch.setattr(profiling, "_profiler_enabled", counting_enabled)
    for _ in range(5):
        with profiling.scope("step.train"):
            pass
    assert checks == [1] * 5 and made == []
    flow_step(False)()
    raft_eval()()
    assert made == [] and profiling.snapshot()["spans"] == {}
    # The control: with a profiler on the same code opens its spans.
    with profile(activities=[ProfilerActivity.CPU]):
        raft_eval()()
    assert "step.eval" in made and profiling.snapshot()["spans"]


@pytest.mark.parametrize("case", ["flow", "raft", "raft_supervised"])
def test_backward_split_once_per_step_between_loss_and_model(case):
    # The supervised step splits at two tensors, every iteration's
    # parameters and upsampling masks: the model's part starts once both
    # have their gradients.
    run = {"flow": lambda: flow_step(False, steps=2),
           "raft": lambda: raft_step(None, steps=2),
           "raft_supervised": lambda: raft_supervised(True, steps=2)}[case]()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    spans = profiling.snapshot()["spans"]
    assert spans["loss.backward"]["steps"] == [0, 1]
    assert spans["model.backward"]["steps"] == [0, 1]
    assert "step.backward" not in spans
    events = program_events(prof)
    ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().endswith("Backward0") or e.name().endswith(
               "Backward1")]
    for step in range(2):
        loss_bw = [e for e in events if e[0] == "loss.backward"][step]
        model_bw = [e for e in events if e[0] == "model.backward"][step]
        assert loss_bw[2] <= model_bw[1]
        in_loss = [o for o in ops if loss_bw[1] <= o[1] and o[2] <= loss_bw[2]]
        in_model = [o for o in ops
                    if model_bw[1] <= o[1] and o[2] <= model_bw[2]]
        assert in_loss and in_model
        # The model's convolutions run after the split, none before it.
        assert not any(o[0] == "ConvolutionBackward0" for o in in_loss)
        assert any(o[0] == "ConvolutionBackward0" for o in in_model)
        convs = [o for o in ops if o[0] == "ConvolutionBackward0"
                 and loss_bw[1] <= o[1] <= model_bw[2]]
        assert all(o[1] >= model_bw[1] for o in convs)


def test_h2d_bytes_of_a_known_batch():
    samples = traj_samples(7, b=3, steps=2, h=8, w=12)
    stack_traj_batch(samples, torch.device("meta"), False)
    host = flow_batch(8, b=2, n=300, capacity=512)
    to_device(host, "meta")
    to_device(host, "cpu")                  # no copy to a device: not counted
    traj = 3 * (7 * 8 * 12 * 4 + 2 * 2 * 8 * 12 * 4 + 2 * 8 * 12)
    flow = sum(np.asarray(v).nbytes for k, v in host.items()
               if k not in ("num_pos_events", "name", "timestamp",
                            "file_index"))
    counters = profiling.snapshot()["counters"]
    assert counters["h2d.pageable_bytes"] == traj + flow
    assert "h2d.pinned_bytes" not in counters

    class Pinned:
        nbytes = 1000

        def is_pinned(self):
            return True

    profiling.count_h2d(Pinned(), "cuda")
    profiling.count_h2d(Pinned(), torch.device("cpu"))
    assert profiling.snapshot()["counters"]["h2d.pinned_bytes"] == 1000


def test_corr_windows_counted_per_lookup():
    # Levels (1, 2) of the event targets and 2 of the frame target: 3
    # targets at level 1, 2 at level 2, each over B x h/8 x w/8 queries,
    # once per iteration.
    raft_supervised(True)()
    counters = profiling.snapshot()["counters"]
    per_lookup = (3 + 2) * 2 * (RH // 8) * (RW // 8)
    assert counters["corr.windows"] == per_lookup * RAFT["iters"]
    assert counters["steps.train"] == 1


def test_steps_and_requests_counted_with_the_profiler_off():
    flow_step(False, steps=2)()
    raft_eval()()
    counters = profiling.snapshot()["counters"]
    assert counters["steps.train"] == 2 and counters["requests.eval"] == 1


def test_snapshot_reads_the_launch_counts_and_reset_clears():
    iwe_vote.iwe_vote_fwd.launches = 7
    profiling.count("steps.train", 3)
    snap = profiling.snapshot()["counters"]
    assert snap["launches.iwe_vote_fwd"] == 7
    assert snap["steps.train"] == 3
    assert {f"launches.{fn.__name__}" for fn in profiling._launch_counted()
            } <= set(snap)
    profiling.reset()
    snap = profiling.snapshot()
    assert snap["spans"] == {} and "steps.train" not in snap["counters"]
    assert iwe_vote.iwe_vote_fwd.launches == 0


@pytest.mark.cuda
def test_profiled_flow_step_on_card():
    """One tiny flow step on the card under torch.profiler: the UNet's 18
    norms launch their kernels; no device event carries a program span's
    name; every span's device ms is finite and positive; the layers' spans
    sum to at most the step's span, which covers the device's busy time and
    lies within the profiled window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run = flow_step(False, device="cuda")
    run()                                   # warm-up: build, cuDNN
    torch.cuda.synchronize()
    profiling.reset()
    cfg = ttn.TrajectoryNetConfig(image_shape=(FH, FW), num_bins=NB,
                                  unet_widths=WIDTHS)
    state = ttn.create_train_state(cfg, "cuda")
    loss_cfg = FocusLossConfig(image_shape=(FH, FW), num_bins=NB, num_knn=8)
    host = flow_batch(3)
    batch = to_device(host, "cuda")
    torch.cuda.synchronize()
    gen = torch.Generator().manual_seed(0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ttn.train_step(state, batch, gen, cfg, loss_cfg,
                       num_pos_events=int(host["num_pos_events"]))
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    device = [e for e in events if e.device_type().name != "CPU"]
    assert device
    assert not any(e.name() in SPANS for e in device)
    snap = profiling.snapshot()
    # The f32 UNet's 18 BatchNorms (+ ReLU), train mode: 2 + 2 reduce
    # launches (the forward's sums, the backward's) and 1 + 1 apply
    # launches each.
    assert snap["counters"]["launches.flax_bn_reduce"] == 18 * 4
    assert snap["counters"]["launches.flax_bn_apply"] == 18 * 2
    spans = snap["spans"]
    for name, entry in spans.items():
        assert entry["device_ms"] is not None, name
        assert math.isfinite(entry["device_ms"]), name
        assert entry["device_ms"] > 0, name
    step = spans["step.train"]["device_ms"]
    layers = sum(spans[k]["device_ms"] for k in (
        "model.forward", "model.backward", "loss.forward", "loss.backward",
        "step.optimizer"))
    assert layers <= step * 1.001
    ivs = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in device)
    busy, end = 0, None
    for a, b in ivs:
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    window = (max(e.start_ns() + e.duration_ns() for e in events)
              - min(e.start_ns() for e in events)) / 1e6
    assert busy / 1e6 <= step * 1.01 + 0.05
    assert step <= window


@pytest.mark.cuda
def test_flow_step_knn_is_one_kernel_launch_on_card():
    """Two exact-KNN flow steps on the card under torch.profiler: one
    `knn_topk` launch per `loss.knn` span, and the only device kernels of
    the top-k class (perfbench/kernels/classes.json's patterns) are the
    fused kernel's, one per span: no torch.topk runs in the step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run = flow_step(False, device="cuda", steps=2)
    run()                                   # warm-up: build, cuDNN
    torch.cuda.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    snap = profiling.snapshot()
    spans = snap["spans"]["loss.knn"]["count"]
    assert spans == 2
    assert snap["counters"]["launches.knn_topk"] == spans
    topk = [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type().name != "CPU" and re.search(
                "topk|TopK|radixFindKthValues|radixSelect|bitonicSort|"
                "sortKeyValueInplace", e.name())]
    assert len(topk) == spans
    assert all("knn_topk_kernel" in name for name in topk), topk

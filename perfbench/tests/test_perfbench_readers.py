"""Each metric reader on a small synthetic traced stretch."""

import math

import pytest

from perfbench import harness, trace


def _run(kind="train"):
    # A 10 ms stretch of 2 steps: a conv (4 ms), a copy (1 ms) overlapping
    # it by 0.5 ms, a top-k (2 ms), the vote forward (1 ms), and a host op.
    ev = [
        {"name": "sm90_xmma_fprop_implicit_gemm_bf16", "device": True,
         "start_us": 1000.0, "dur_us": 4000.0},
        {"name": "void at::native::direct_copy_kernel_cuda", "device": True,
         "start_us": 4500.0, "dur_us": 1000.0},
        {"name": "void at::native::sbtopk::gatherTopK<float>", "device": True,
         "start_us": 6000.0, "dur_us": 2000.0},
        {"name": "iwe_vote_fwd_kernel", "device": True, "start_us": 8000.0,
         "dur_us": 1000.0},
        {"name": "Memcpy HtoD (Pinned -> Device)", "device": True,
         "start_us": 12000.0, "dur_us": 1000.0},
        {"name": "cudaStreamSynchronize", "device": False,
         "start_us": 9000.0, "dur_us": 1000.0},
    ]
    return {"kind": kind, "events": ev, "stretch_us": (0.0, 10000.0),
            "stretch_steps": 2, "classes": trace.load_classes(),
            "flops_per_step": 1e12, "peak_flops": 1e15,
            "bounds": {"iwe_vote_fwd": 0.25e-3, "voxel_vote": 1.0},
            "setup_s": 12.5, "samples": 28, "window_s": 2.0,
            "latencies_ms": [float(x) for x in range(1, 101)]}


def _read(name, run):
    return harness.read_metric({"name": name}, run)


def test_idle_share_is_the_union_of_device_intervals():
    # busy: 1000-5500 (conv and copy), 6000-9000; the HtoD copy is outside.
    assert _read("idle_share.train", _run()) == pytest.approx(
        100 * (1 - 7.5 / 10))


def test_class_readers_per_step():
    run = _run()
    assert _read("conv_gemm_ms.train", run) == pytest.approx(2.0)
    assert _read("copy_ms.train", run) == pytest.approx(0.5)
    assert _read("topk_ms.train", run) == pytest.approx(1.0)


def test_mfu_over_the_stretch():
    assert _read("mfu.train", _run()) == pytest.approx(
        100 * 2e12 / (0.01 * 1e15))


def test_kernel_roofline_counts_observed_bounded_calls_only():
    # iwe_vote_fwd: 2 steps x 0.25 ms least against 1 ms taken; voxel_vote
    # has a bound but no launch, so it stays out.
    assert _read("kernel_roofline.train", _run()) == pytest.approx(50.0)


def test_readers_leave_out_what_they_cannot_read():
    run = _run()
    assert _read("idle_share.eval", run) is None     # another kind of cell
    assert _read("eval_samples_per_s", run) is None
    run["events"] = [e for e in run["events"] if "topk" not in e["name"]
                     and "TopK" not in e["name"]]
    assert _read("topk_ms.train", run) is None
    run["bounds"] = {}
    assert _read("kernel_roofline.train", run) is None
    untraced = {k: v for k, v in run.items() if k != "events"}
    assert _read("mfu.train", untraced) is None


def test_end_to_end_readers():
    run = _run()
    assert _read("train_samples_per_s", run) == pytest.approx(14.0)
    assert _read("setup_s", run) == 12.5
    ev = _run("eval")
    assert _read("eval_samples_per_s", ev) == pytest.approx(14.0)
    assert _read("eval_request_ms_p90", ev) == pytest.approx(90.1)


def test_breakdown_names_the_gaps_by_the_host():
    run = _run()
    bd = trace.breakdown(run["events"], run["stretch_us"])
    assert bd["device_ops"][0][0].startswith("sm90_xmma")
    assert math.isclose(sum(t for _, t in bd["idle_gaps"]), 2.5e-3)
    got = sorted((name, round(t, 9)) for name, t in bd["idle_gaps"])
    host = "no torch op (Python or NumPy on the host)"
    assert got == [("cudaStreamSynchronize", 1e-3), (host, 0.5e-3),
                   (host, 1e-3)]


@pytest.mark.parametrize("name, cls", [
    ("void cudnn::engines_precompiled::nchwToNhwcKernel", "copy"),
    ("sm90_xmma_wgrad_implicit_gemm_bf16", "conv_gemm"),
    ("ampere_sgemm_128x64_nn", "conv_gemm"),
    ("void at::native::mbtopk::radixFindKthValues<float>", "topk"),
    ("Memcpy DtoD (Device -> Device)", "copy"),
    ("void at::native::vectorized_elementwise_kernel<4, relu>", "other"),
    ("softmax_interp_fwd_kernel", "port"),
])
def test_kernel_classes(name, cls):
    assert trace.classify(name, trace.load_classes())[0] == cls

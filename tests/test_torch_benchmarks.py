"""The port's benchmarks/, utils/profiling.py and ops/scatter.py against the
JAX package's, on the CPU.

  * components: each timed case at 32 x 48, m = 2^10, K = 4 gives the JAX
    function's value on the same numpy inputs (the vote and its gradient,
    the device voxel grid, the focus loss forward and gradient with the
    exact KNN, with softmax interpolation and on cell-sorted events with
    their cell ends, the JAX side with use_pallas_interp=True, whose
    function the port computes), at the tolerances of
    test_torch_iwe_vote.py, test_torch_voxel_vote.py and
    test_torch_focus_loss.py;
  * the printed metric keys of components and raft (default flags and
    --supervised, Bezier degree 2, one iteration, 64 x 64) are the JAX
    modules' less the three TPU-only ones, with finite positive values;
  * scaling --virtual 2 and scaling_hosts at N in {1, 2} as processes, the
    two started together, each with a timeout of RUN_TIMEOUT_S;
  * every entry point exits with a message when CUDA is absent;
  * device_timer's call count and result, trace's file;
  * scatter_add_1d (values, gradient, the same bits in two calls) and
    scatter_add_direct against JAX on tests/test_scatter.py's cases.
"""

import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import motionpriorcmax_tpu.training.trajectory_net as jtn
from motionpriorcmax_tpu.losses import FocusLossConfig as JaxFocusCfg
from motionpriorcmax_tpu.losses import focus_loss as jax_focus_loss
from motionpriorcmax_tpu.ops.events import \
    iwe_bilinear_vote_batch as jax_vote
from motionpriorcmax_tpu.ops.knn import knn_blocked as jax_knn
from motionpriorcmax_tpu.ops.knn import knn_grid_window as jax_knn_grid
from motionpriorcmax_tpu.ops.scatter import scatter_add_1d as jax_scatter
from motionpriorcmax_tpu.ops.scatter import \
    scatter_add_direct as jax_scatter_direct
from motionpriorcmax_tpu_torch.benchmarks import components, raft
from motionpriorcmax_tpu_torch.ops import scatter_add_1d, scatter_add_direct
from motionpriorcmax_tpu_torch.utils.profiling import (device_timer, scope,
                                                       trace)
from tests._one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
JAX_BENCH = ROOT / "motionpriorcmax_tpu" / "benchmarks"
SMALL = dict(h=32, w=48, nbins=15, k=4, b=2, m=1 << 10)
# The JAX module's keys that time the TPU's scatter layouts.
TPU_ONLY = {"iwe_scatter_sorted_events_per_s", "iwe_matmul_events_per_s",
            "iwe_matmul_fwd_bwd_events_per_s"}
RUN_TIMEOUT_S = 240


def jax_component_keys():
    """The metric keys of JAX benchmarks/components.py, read from its
    source: results["..."] and the f-string over its scatter_impl loop."""
    src = (JAX_BENCH / "components.py").read_text()
    keys = set(re.findall(r'results\["([a-z0-9_]+)"\]', src))
    impls = re.search(r'for impl in \(([^)]*)\)', src).group(1)
    assert 'results[f"iwe_scatter_{impl}_events_per_s"]' in src
    keys |= {f"iwe_scatter_{i}_events_per_s"
             for i in re.findall(r'"([a-z]+)"', impls)}
    return keys


def metric_lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith('{"metric"')]


# -- components: each case against the JAX function ---------------------------

@pytest.fixture(scope="module")
def cases():
    return components.build_cases("cpu", **SMALL)


def arrays(case):
    return [a.numpy() for a in case.args]


def loss_cfgs(method):
    """The JAX module's focus-loss configs at SMALL (components.py:103-134),
    the softmax one with the Pallas function the port computes."""
    kw = dict(image_shape=(SMALL["h"], SMALL["w"]), num_bins=SMALL["nbins"],
              num_knn=SMALL["k"], polarity_aware_batching=False,
              knn_block_size=1200)
    if method == "softmax":
        kw.update(knn_method="softmax", knn_block_size=512,
                  use_pallas_interp=True)
    return JaxFocusCfg(**kw)


def moving_traj(traj, seed=1):
    """The case's trajectories jittered and moving, so that no two
    neighbours tie at the K-th distance (lax.top_k and torch.topk break
    ties differently) and the flow is not zero."""
    rng = np.random.default_rng(seed)
    b, t, n, _ = traj.shape
    times = np.concatenate([[0.5], (np.arange(t - 1) + 0.5) / (t - 1)])
    out = traj + rng.uniform(-0.3, 0.3, (b, 1, n, 2)) \
        + times[None, :, None, None] * rng.normal(0, 2, (b, 1, n, 2))
    return out.astype(np.float32)


def test_components_vote_and_gradient_match_jax(cases):
    # test_torch_iwe_vote.py's atol 1e-5 (a pixel holds a few unit votes;
    # the gradient's four products add in another order), here relative
    # to the largest value: |img| reaches ~10 with m = 2^10 on 32 x 48.
    coords, wgt = arrays(cases["iwe_scatter_direct_events_per_s"])
    h, w = SMALL["h"], SMALL["w"]

    def jvote(c, wg):
        return jax_vote(c, wg, height=h, width=w)

    want = np.asarray(jvote(jnp.asarray(coords), jnp.asarray(wgt)))
    got = cases["iwe_scatter_direct_events_per_s"].fn(
        *cases["iwe_scatter_direct_events_per_s"].args).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    dc_j = np.asarray(jax.grad(lambda c: jnp.sum(jvote(c, jnp.asarray(
        wgt)) ** 2))(jnp.asarray(coords)))
    case = cases["iwe_scatter_fwd_bwd_events_per_s"]
    dc = case.fn(*case.args).numpy()
    assert np.abs(dc_j).max() > 0
    np.testing.assert_allclose(dc, dc_j, rtol=0,
                               atol=1e-5 * np.abs(dc_j).max())


def test_components_voxel_grid_matches_jax(cases):
    # test_torch_voxel_vote.py's mean_std tolerance: 1e-5 of the largest.
    # The port's events carry t = t_norm / 14 in [0, 1], which the vote
    # scales back by 14 in f32.
    case = cases["voxelize_events_per_s"]
    (ev,) = arrays(case)
    jcfg = jtn.TrajectoryNetConfig(image_shape=(SMALL["h"], SMALL["w"]),
                                   num_bins=SMALL["nbins"])
    want = np.asarray(jax.jit(lambda e: jtn.voxelize_batch_on_device(
        jcfg, e))(jnp.asarray(ev)))
    got = case.fn(*case.args).numpy()
    assert got.shape == (1, SMALL["nbins"], SMALL["h"], SMALL["w"])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("key,method,sorted_events", [
    ("focus_loss_exact_fwd_bwd_events_per_s", "exact", False),
    ("focus_loss_softmax_fwd_bwd_events_per_s", "softmax", False),
    ("focus_loss_sorted_fwd_bwd_events_per_s", "softmax", True),
])
def test_components_focus_loss_and_gradient_match_jax(cases, key, method,
                                                      sorted_events):
    # test_torch_focus_loss.py's tolerances: loss rtol 1e-5, gradient
    # atol 1e-4 of its largest entry.  The exact case's forward alone is
    # the forward-only case's function, checked on the same inputs.
    case = cases[key]
    traj, *rest = arrays(case)
    traj = moving_traj(traj)
    times = np.concatenate([[0.5], (np.arange(SMALL["nbins"]) + 0.5)
                            / SMALL["nbins"]]).astype(np.float32)
    ends = jnp.asarray(rest[1]) if sorted_events else None
    jcfg = loss_cfgs(method)
    l_j, g_j = jax.jit(jax.value_and_grad(lambda t, ev: jax_focus_loss(
        jcfg, t, jnp.asarray(times), ev, cell_ends=ends)[0]))(
        jnp.asarray(traj), jnp.asarray(rest[0]))
    g = case.fn(torch.from_numpy(traj), *case.args[1:]).numpy()
    g_j = np.asarray(g_j)
    assert np.abs(g_j).max() > 0
    np.testing.assert_allclose(g, g_j, rtol=0, atol=1e-4 * np.abs(g_j).max())
    if method == "exact":
        fwd = cases["focus_loss_exact_fwd_events_per_s"]
        got = float(fwd.fn(torch.from_numpy(traj), *fwd.args[1:]))
        np.testing.assert_allclose(got, float(l_j), rtol=1e-5)


def test_components_knn_match_jax(cases):
    # Random uniform points: no ties; the same neighbours in the same
    # order, squared distances refined as JAX refines them (rtol 1e-6);
    # the grid KNN is JAX's knn_grid_window vmapped over the databases.
    (db,) = arrays(cases["knn_exact_b2x15_19200x19200_k32_ms"])
    idx, dist = cases["knn_exact_b2x15_19200x19200_k32_ms"].fn(
        *cases["knn_exact_b2x15_19200x19200_k32_ms"].args)
    gidx, gdist = cases["knn_grid_ms"].fn(*cases["knn_grid_ms"].args)
    queries = np.random.default_rng(0).uniform(
        0, SMALL["h"], ((SMALL["h"] // 4) * (SMALL["w"] // 4), 2)).astype(
        np.float32)
    h4, w4 = SMALL["h"] // 4, SMALL["w"] // 4
    for g in (0, len(db) - 1):
        ji, jd = jax_knn(jnp.asarray(queries), jnp.asarray(db[g]),
                         SMALL["k"], block_size=1200)
        np.testing.assert_array_equal(idx[g].numpy(), np.asarray(ji))
        np.testing.assert_allclose(dist[g].numpy(), np.asarray(jd),
                                   rtol=1e-6)
        ji, jd = jax_knn_grid(jnp.asarray(queries), jnp.asarray(db[g]),
                              SMALL["k"], cell_size=4.0, grid_hw=(h4, w4),
                              window_radius=6, cell_capacity=6)
        np.testing.assert_allclose(gdist[g].numpy(), np.asarray(jd),
                                   rtol=1e-6)
        finite = np.isfinite(np.asarray(jd))
        np.testing.assert_array_equal(gidx[g].numpy()[finite],
                                      np.asarray(ji)[finite])


# -- printed keys -------------------------------------------------------------

def test_components_prints_jax_keys(capsys):
    results = components.run("cpu", iters=1, **SMALL)
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[0]) == {"device": "cpu"}
    recs = metric_lines("\n".join(lines))
    assert [r["metric"] for r in recs] == list(results)
    assert set(results) == jax_component_keys() - TPU_ONLY
    assert len(results) == len(jax_component_keys()) - 3
    for r in recs:
        assert set(r) == {"metric", "value"}
        assert math.isfinite(r["value"]) and r["value"] > 0, r


# The record fields of JAX benchmarks/raft.py (:105-106, :117-118,
# :144-148, :178-186).
RAFT_FIELDS = {
    "raft_spline_fwd_12it_evimo2_ms": {"metric", "value", "batch"},
    "raft_spline_valstep_ms": {"metric", "value", "batch"},
    "raft_spline_supervised_trainstep_ms": {
        "metric", "value", "unit", "batch", "corr_dtype", "vs_baseline"},
    "raft_spline_selfsup_trainstep_ms": {
        "metric", "value", "unit", "batch", "events", "corr_dtype",
        "compute_dtype", "gamma", "gamma_sample_k", "events_per_s",
        "vs_baseline"},
}


@pytest.mark.parametrize("flags,train_key", [
    ([], "raft_spline_selfsup_trainstep_ms"),
    (["--supervised"], "raft_spline_supervised_trainstep_ms"),
])
def test_raft_prints_jax_keys(capsys, tmp_path, flags, train_key):
    src = (JAX_BENCH / "raft.py").read_text()
    assert set(re.findall(r'"metric": "([a-z0-9_]+)"', src)) == set(
        RAFT_FIELDS)
    args = raft.parse_args(["--device", "cpu", "--write-json",
                            str(tmp_path / "rec.json"), *flags])
    records = raft.run(args, "cpu", hw=(64, 64), events_per_sample=1 << 10,
                       calls={k: (1, 1) for k in raft.CALLS},
                       bezier_degree=2, iters=1)
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[0]) == {"device": "cpu"}
    assert metric_lines("\n".join(lines)) == records
    assert [r["metric"] for r in records] == [
        "raft_spline_fwd_12it_evimo2_ms", "raft_spline_valstep_ms",
        train_key]
    for r in records:
        assert set(r) == RAFT_FIELDS[r["metric"]]
        for k in ("value", "vs_baseline", "events_per_s"):
            if k in r:
                assert math.isfinite(r[k]) and r[k] > 0, r
    assert json.loads((tmp_path / "rec.json").read_text()) == records[-1]


# -- scaling and scaling_hosts as processes -----------------------------------

@pytest.fixture(scope="module")
def world_runs(tmp_path_factory):
    """{name: (returncode, output)} of the two entry points, started
    together."""
    runs = {
        "scaling": ["motionpriorcmax_tpu_torch.benchmarks.scaling",
                    "--virtual", "2", "--hw", "32", "48", "--events", "1024",
                    "--iters", "1"],
        "scaling_hosts": ["motionpriorcmax_tpu_torch.benchmarks.scaling_hosts",
                          "--worlds", "1,2", "--device", "cpu"]}
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    deadline = time.monotonic() + RUN_TIMEOUT_S
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", *argv], cwd=tmp_path_factory.mktemp(name),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, argv in runs.items()}
    out = {}
    try:
        for name, p in procs.items():
            try:
                text, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                text, _ = p.communicate()
                text = f"(timed out after {RUN_TIMEOUT_S} s)\n{text}"
            out[name] = (p.returncode, text)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_scaling_virtual_two_ranks(world_runs):
    rc, text = world_runs["scaling"]
    assert rc == 0, text[-4000:]
    assert json.loads(text.splitlines()[0]) == {"device": "cpu"}
    recs = metric_lines(text)
    assert [r["devices"] for r in recs] == [1, 2]
    for r in recs:
        assert r["metric"] == "scaling_events_per_s"
        assert set(r) == {"metric", "devices", "value", "efficiency"}
        assert math.isfinite(r["value"]) and r["value"] > 0
        assert math.isfinite(r["efficiency"]) and r["efficiency"] > 0
    assert recs[0]["efficiency"] == 1.0


def test_scaling_hosts_parity_verdict(world_runs):
    rc, text = world_runs["scaling_hosts"]
    assert rc == 0, text[-4000:]
    lines = [json.loads(line) for line in text.splitlines()
             if line.startswith("{")]
    assert lines[0] == {"device": "cpu"}
    worlds = [rec for rec in lines if "hosts" in rec]
    assert [w["hosts"] for w in worlds] == [1, 2]
    for w in worlds:
        assert w["steps"] == 1 and math.isfinite(w["best_val"])
    verdict = lines[-1]
    assert verdict["parity_vs_single_process"] is True
    assert set(verdict["best_vals"]) == {"1", "2"}


@pytest.mark.parametrize("name", ["components", "raft", "scaling",
                                  "scaling_hosts"])
def test_entry_point_without_cuda_exits_with_message(monkeypatch, name):
    import importlib

    module = importlib.import_module(
        f"motionpriorcmax_tpu_torch.benchmarks.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="is_available"):
        module.main([])


# -- utils/profiling.py -------------------------------------------------------

def test_device_timer_calls_and_result():
    calls = []

    def fn(x):
        calls.append(1)
        return x + len(calls)

    dt, out = device_timer(fn, torch.zeros(3), iters=4, warmup=2)
    assert len(calls) == 6 and torch.equal(out, torch.full((3,), 6.0))
    assert dt >= 0
    # The device from the result when the arguments hold no tensor.
    dt, out = device_timer(lambda: torch.ones(1), iters=1, warmup=1)
    assert float(out) == 1.0
    with pytest.raises(ValueError, match="no tensor"):
        device_timer(lambda: 1.0, iters=1, warmup=1)


def test_trace_writes_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")):
        with scope("bench_scope"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "bench_scope" for e in events)


# -- ops/scatter.py -----------------------------------------------------------

def scatter_case(name, rng):
    if name == "random":
        n, m = 100, 5000
        return n, rng.integers(0, n, m), rng.normal(size=m)
    if name == "collisions":
        return 4, np.zeros(1000, int), np.ones(1000)
    return 10, np.array([0, 5, -1, 10, 3, 5, 12]), rng.normal(size=7)


@pytest.mark.parametrize("name", ["random", "collisions", "out_of_range"])
def test_scatter_add_matches_jax(name):
    # Values: each run summed in input order here, by cumsum differences in
    # JAX (an absolute error of a few ulps of the running sum, <= ~1e-5 for
    # 5000 normal values), and index_add_ against XLA's scatter-add.  The
    # gradient is the gather g[idx] on both sides: equal.  Two calls give
    # the same bits.
    n, idx, vals = scatter_case(name, np.random.default_rng(0))
    idx, vals = idx.astype(np.int32), vals.astype(np.float32)
    cot = np.random.default_rng(1).normal(size=n).astype(np.float32)
    want = np.asarray(jax_scatter(n, jnp.asarray(idx), jnp.asarray(vals)))
    g_want = np.asarray(jax.grad(lambda v: jnp.sum(jax_scatter(
        n, jnp.asarray(idx), v) * cot))(jnp.asarray(vals)))
    v = torch.from_numpy(vals).requires_grad_()
    got = scatter_add_1d(n, torch.from_numpy(idx), v)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(v.grad.numpy(), g_want)
    again = scatter_add_1d(n, torch.from_numpy(idx), torch.from_numpy(vals))
    assert torch.equal(got.detach(), again)
    direct = scatter_add_direct(n, torch.from_numpy(idx),
                                torch.from_numpy(vals)).numpy()
    np.testing.assert_allclose(direct, np.asarray(jax_scatter_direct(
        n, jnp.asarray(idx), jnp.asarray(vals))), rtol=0, atol=1e-5)
    np.testing.assert_allclose(direct, got.detach().numpy(), rtol=0,
                               atol=1e-4)
    if name == "out_of_range":
        assert float(got.detach().sum()) == pytest.approx(
            float(vals[[0, 1, 4, 5]].sum()), rel=1e-6)

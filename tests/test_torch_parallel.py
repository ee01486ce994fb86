"""The port's multi-process training (motionpriorcmax_tpu_torch/parallel/)
against the JAX package, on the CPU.

Worlds of gloo processes (tests/_torch_parallel_worker.py, torch only) run
the port's sharded steps while this process computes the JAX side:

  * focus_loss_event_sharded on 4 ranks, mesh (1, 4), against JAX's
    focus_loss_event_sharded on the 8-device mesh (data=2, event=4):
    polarity off and on, unsorted and cell-sorted with LUT-cell ends, with
    tests/test_event_parallel.py's tolerances;
  * the flow train_step at meshes (2, 1), (1, 2) and (2, 2) against JAX's
    single-device train_step on the global batch (SGD, as
    tests/test_training.py explains; smoothness on, BatchNorm in the UNet,
    cell-sorted events with ends and a host voxel, and unsorted events
    whose voxel grid the step votes): loss rtol 2e-5, parameters and
    BatchNorm statistics atol 2e-4 rtol 1e-3;
  * raft_train_step (self-supervised) and raft_supervised_train_step
    (with flow_valid) at (2, 1) and (1, 2) against JAX's single-device
    steps, at tests/test_raft_sharded.py's geometry and tolerances;
  * train_traj on two processes at (2, 1) and (1, 2), validating every
    step, against train_traj in one process;
  * MetricBank.reduce_across_processes, make_mesh's refusals,
    `flow-train --mesh 2,1` on two processes over a synthetic DSEC tree
    whose val split is odd (every sample validated), and `traj-train
    --mesh 2,1` on two processes against `--mesh 1,1` in one, over a
    synthetic EVIMO2 tree.

Every world has a timeout of WORLD_TIMEOUT_S; a rank that fails or hangs
fails every test that reads its world.
"""

import dataclasses
import functools
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import optax
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

import motionpriorcmax_tpu.training.raft_spline as jrs
import motionpriorcmax_tpu.training.trajectory_net as jtn
from motionpriorcmax_tpu.cli.main import _parse_mesh as jax_parse_mesh
from motionpriorcmax_tpu.data.loader import DataLoader as JaxLoader
from motionpriorcmax_tpu.losses import FocusLossConfig as JaxFocusCfg
from motionpriorcmax_tpu.losses import get_reconstruction_times as jax_times
from motionpriorcmax_tpu.models.raft_spline import RAFTSpline as JaxRAFT
from motionpriorcmax_tpu.parallel import make_mesh as jax_make_mesh
from motionpriorcmax_tpu.parallel.event_parallel import \
    focus_loss_event_sharded as jax_event_sharded
from motionpriorcmax_tpu_torch.cli.main import parse_mesh
from motionpriorcmax_tpu_torch.data.collate import collate_fixed_capacity
from motionpriorcmax_tpu_torch.data.host_ops import (lut_cell_sort,
                                                     voxelize_normalized_host)
from motionpriorcmax_tpu_torch.data.loader import DataLoader
from motionpriorcmax_tpu_torch.losses import FocusLossConfig
from motionpriorcmax_tpu_torch.parallel import make_mesh
from motionpriorcmax_tpu_torch.training.checkpoint import (
    flax_raft_spline_to_torch, flax_unet_to_torch)
from tests import test_event_parallel as tep
from tests.test_data_dsec import make_synthetic_dsec_sequence
from tests.test_raft_sharded import make_raft_batch
from tests.test_raft_training import make_synthetic_evimo2, tiny_cfg
from tests.test_torch_flow_train import (H, LOSS_KW, NB, W, WIDTHS, configs,
                                         jax_state, make_events,
                                         make_val_sequence)
from tests.test_torch_raft_spline import SMALL
from tests.test_torch_raft_train import supervised_batch
from tests.test_torch_raft_train import variables as raft_variables
from tests._one_thread import one_torch_thread  # noqa: F401

WORKER = Path(__file__).parent / "_torch_parallel_worker.py"
WORLD_TIMEOUT_S = 120
LR = 0.05
RAFT_HW = (32, 32)
RAFT_LOSS_KW = dict(image_shape=RAFT_HW, num_bins=5, num_knn=4,
                    smooth_weight=0.01, polarity_aware_batching=False,
                    knn_block_size=64)
WORLDS = {"events": 4, "steps": 2, "cli": 2}
VAL_WINDOWS = 3                    # the cli tree's val split: odd
EVENT_CASES = [(pol, srt) for pol in (False, True) for srt in (False, True)]
FLOW_CASES = ("sorted_host_voxel", "unsorted_step_voxel")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def port_cfg(jcfg):
    """The port's FocusLossConfig of a JAX one (the fields both have)."""
    fields = {f.name for f in dataclasses.fields(FocusLossConfig)}
    return {k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields}


# -- inputs and the JAX side ------------------------------------------------

def event_inputs():
    out, refs = {}, {}
    mesh = jax_make_mesh(data=2, event=4)
    for pol, srt in EVENT_CASES:
        name = f"pol{int(pol)}_sorted{int(srt)}"
        jcfg = tep.make_cfg(smooth_weight=0.01, polarity_aware_batching=pol)
        events, times, traj, npos = tep._setup(np.random.default_rng(0), pol)
        ends = None
        if srt:
            ev, ends = lut_cell_sort(np.asarray(events[0]), (tep.H, tep.W),
                                     tep.NBINS, jcfg.lut_superpixel_size,
                                     num_pos_events=npos)
            events, ends = jnp.asarray(ev[None]), jnp.asarray(ends[None])

        def f(t, ev=events, ends=ends, jcfg=jcfg, npos=npos, times=times):
            loss, _, misc = jax_event_sharded(jcfg, t, times, ev, mesh,
                                              num_pos_events=npos,
                                              cell_ends=ends)
            return loss, misc["iwes"]

        (loss, iwes), grad = jax.jit(jax.value_and_grad(f, has_aux=True))(
            traj)
        refs[name] = {"loss": float(loss), "iwes": np.asarray(iwes),
                      "grad": np.asarray(grad)}
        out[name] = {
            "loss": port_cfg(jcfg), "npos": npos,
            "traj": torch.from_numpy(np.array(traj)),
            "times": torch.from_numpy(np.array(times)),
            "events": torch.from_numpy(np.array(events)),
            "ends": None if ends is None else torch.from_numpy(
                np.array(ends))}
    return out, refs


def flow_batch(name, seed=41, b=2, capacity=4096, n=2500):
    """Polarity-packed numpy batch: cell-sorted with ends and a host voxel,
    or unsorted without a voxel (the step votes it)."""
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(b):
        ev = make_events(rng, n)
        s = {"pos_events": ev[ev[:, 3] == 1],
             "neg_events": ev[ev[:, 3] == 0]}
        if name == "sorted_host_voxel":
            s["voxel"] = voxelize_normalized_host(ev, NB, H, W)
        samples.append(s)
    sort = ((H, W), NB, 4) if name == "sorted_host_voxel" else None
    return collate_fixed_capacity(samples, capacity, True,
                                  lut_cell_sort_params=sort)


def flow_inputs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtn, "UNet", functools.partial(jtn.UNet, widths=WIDTHS))
        jcfg, tcfg = configs()
        js = jax_state(jcfg)
        js = js.replace(tx=optax.sgd(LR), opt_state=optax.sgd(LR).init(
            js.params))
        rng = jax.random.PRNGKey(7)
        jloss = JaxFocusCfg(**LOSS_KW)
        times = torch.from_numpy(np.array(jax_times(jloss, rng)))
        cases, refs = {}, {}
        for i, name in enumerate(FLOW_CASES):
            batch = flow_batch(name, seed=41 + i)
            npos = batch["num_pos_events"]
            jbatch = {k: jnp.asarray(v) for k, v in batch.items()
                      if k in ("events", "voxel", "lut_cell_ends")}
            new, logs = jax.jit(functools.partial(
                jtn.train_step, cfg=jcfg, loss_cfg=jloss,
                num_pos_events=npos))(js, jbatch, rng)
            refs[name] = {"loss": float(logs["train_losses/total"]),
                          "unet": flax_unet_to_torch(
                              new.params["unet"], new.batch_stats["unet"])}
            cases[name] = {"batch": batch, "times": times,
                           "loss": dict(LOSS_KW)}
        init = flax_unet_to_torch(js.params["unet"], js.batch_stats["unet"])
    flow_cfg = {f.name: getattr(tcfg, f.name)
                for f in dataclasses.fields(tcfg)}
    return {"flow": cases, "flow_init": init, "flow_cfg": flow_cfg}, refs


def raft_inputs(variables):
    cfg = tiny_cfg(iters=2, remat_iters=False)
    state = jrs.RAFTTrainState.create(
        apply_fn=JaxRAFT(cfg).apply, params=variables["params"],
        tx=optax.sgd(LR), batch_stats=variables["batch_stats"])
    rng = jax.random.PRNGKey(7)
    jloss = JaxFocusCfg(**RAFT_LOSS_KW)
    selfsup = make_raft_batch(np.random.default_rng(0), batch=4)
    selfsup = {"ev_repr": selfsup["ev_repr"], "events": selfsup["events"]}
    supervised = supervised_batch(5, b=4)
    cases, refs = {}, {}
    step = jax.jit(functools.partial(jrs.raft_train_step, cfg=cfg,
                                     loss_cfg=jloss))
    new, logs = step(state, {k: jnp.asarray(v) for k, v in selfsup.items()},
                     rng)
    refs["selfsup"] = (new, logs)
    cases["selfsup"] = {"batch": selfsup, "loss": dict(RAFT_LOSS_KW),
                        "times": torch.from_numpy(np.array(
                            jax_times(jloss, rng)))}
    step = jax.jit(functools.partial(jrs.raft_supervised_train_step,
                                     cfg=cfg))
    new, logs = step(state, {k: jnp.asarray(v)
                             for k, v in supervised.items()}, rng)
    refs["supervised"] = (new, logs)
    cases["supervised"] = {"batch": supervised}
    refs = {k: {"loss": float(logs["train_losses/total"]),
                "state": flax_raft_spline_to_torch(
                    {"params": new.params, "batch_stats": new.batch_stats})}
            for k, (new, logs) in refs.items()}
    return {"raft": cases, "raft_cfg": dict(SMALL),
            "raft_init": flax_raft_spline_to_torch(variables),
            "traj_loop": traj_loop_inputs()}, refs


def traj_loop_inputs():
    """Two global self-supervised batches of 4 and four validation samples
    (2 GT flows each) for train_traj at RAFT_HW."""
    rng = np.random.default_rng(5)
    batches = [make_raft_batch(rng, batch=4) for _ in range(2)]
    val = [{"ev_repr": rng.normal(size=(7,) + RAFT_HW).astype(np.float32),
            "flow": rng.normal(size=(2, 2) + RAFT_HW).astype(np.float32)}
           for _ in range(4)]
    return {"batches": batches, "val": val, "val_ts": (0.5, 1.0), "seed": 3}


def write_cli_tree(out_dir: Path):
    """The cli world's trees: DSEC with an odd val split (VAL_WINDOWS) and
    EVIMO2 with imo/train and imo/eval, each of two samples."""
    data = out_dir / "dsec"
    data.mkdir()
    make_synthetic_dsec_sequence(data, name="zurich_city_04_d")
    make_val_sequence(data, n_windows=VAL_WINDOWS)
    evimo2 = make_synthetic_evimo2(out_dir / "evimo2", n_flows=2)
    shutil.copytree(evimo2 / "imo/eval/seq_a", evimo2 / "imo/train/seq_t")
    config = {
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
    (out_dir / "cfg.yaml").write_text(yaml.safe_dump(config))


def start_world(world: str, out_dir: Path):
    """(deadline, the world's rank processes)."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return time.time() + WORLD_TIMEOUT_S, [subprocess.Popen(
        [sys.executable, str(WORKER), world, str(r), str(WORLDS[world]),
         str(port), str(out_dir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for r in range(WORLDS[world])]


def finish_world(deadline: float, procs, out_dir: Path):
    """Each rank's results (its output under 'stdout'), or the error text
    of the world."""
    logs, outs, failed = [], [], False
    start = deadline - WORLD_TIMEOUT_S
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            failed = True
            out = f"(timed out after {WORLD_TIMEOUT_S} s)\n{out}"
        failed |= p.returncode != 0
        logs.append(f"--- rank {r} (rc {p.returncode}, "
                    f"{time.time() - start:.1f} s) ---\n{out[-4000:]}")
        outs.append(out)
    if failed:
        return "\n".join(logs)
    print(f"world {out_dir.name}: {time.time() - start:.1f} s")
    return [dict(torch.load(out_dir / f"out{r}.pt", weights_only=False),
                 stdout=outs[r]) for r in range(len(procs))]


@pytest.fixture(scope="module")
def results(tmp_path_factory, raft_variables):
    """(per-world rank results, JAX references).  The worlds start when
    the JAX side is done: JAX's compiles beside them would slow them
    several times over."""
    dirs = {w: tmp_path_factory.mktemp(w) for w in WORLDS}
    refs = {}
    write_cli_tree(dirs["cli"])
    torch.save({"traj_port": _free_port()}, dirs["cli"] / "inputs.pt")
    flow, refs["flow"] = flow_inputs()
    raft, refs["raft"] = raft_inputs(raft_variables)
    events, refs["events"] = event_inputs()
    torch.save({**flow, **raft, "lr": LR}, dirs["steps"] / "inputs.pt")
    torch.save({**flow, "events": events, "lr": LR},
               dirs["events"] / "inputs.pt")
    procs = {w: start_world(w, dirs[w]) for w in WORLDS}
    out = {w: finish_world(*p, dirs[w]) for w, p in procs.items()}
    out["cli_dir"] = dirs["cli"]
    out["steps_inputs"] = {**raft, "lr": LR}
    return out, refs


def world(results, name):
    out = results[0][name]
    if isinstance(out, str):
        pytest.fail(f"world {name!r} failed:\n{out}")
    return out


def assert_state(got, want, atol, rtol):
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=atol,
                                   rtol=rtol, err_msg=k)


# -- the tests ----------------------------------------------------------------

@pytest.mark.parametrize("pol,srt", EVENT_CASES)
def test_event_sharded_loss_matches_jax(results, pol, srt):
    name = f"pol{int(pol)}_sorted{int(srt)}"
    want = results[1]["events"][name]
    for rank, out in enumerate(world(results, "events")):
        got = out[f"events/{name}"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-5)
        np.testing.assert_allclose(got["iwes"].numpy(), want["iwes"],
                                   atol=1e-4)
        np.testing.assert_allclose(got["grad"].numpy(), want["grad"],
                                   atol=1e-4 if srt else 1e-5, rtol=1e-3,
                                   err_msg=f"rank {rank}")


@pytest.mark.parametrize("mesh", ["2x1", "1x2", "2x2"])
@pytest.mark.parametrize("case", FLOW_CASES)
def test_sharded_flow_step_matches_jax_single_device(results, case, mesh):
    want = results[1]["flow"][case]
    outs = world(results, "events" if mesh == "2x2" else "steps")
    for out in outs:
        got = out[f"flow/{case}/{mesh}"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-5)
        assert_state(got["unet"], want["unet"], atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
@pytest.mark.parametrize("case", ["selfsup", "supervised"])
def test_sharded_raft_steps_match_jax_single_device(results, case, mesh):
    want = results[1]["raft"][case]
    for out in world(results, "steps"):
        got = out[f"raft/{case}/{mesh}"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=5e-5)
        assert_state(got["state"], want["state"], atol=5e-4, rtol=2e-3)


def test_metric_bank_reduces_across_processes(results):
    for out in world(results, "steps"):
        assert out["bank"]["epe"] == pytest.approx(1.5)
        # A key one rank lacks counts 0 there.
        assert out["bank"]["only_rank0"] == pytest.approx(4.0)


def test_make_mesh_refuses_uncovered_worlds(results):
    for out in world(results, "events"):
        assert out["refused"] == [(3, 1), (2, 1), (4, 2)]
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(1, 1)


def test_flow_train_cli_two_processes(results):
    outs = world(results, "cli")
    cli_dir = results[0]["cli_dir"]
    assert [o["rc"] for o in outs] == [0, 0]
    rank0, rank1 = cli_dir / "rank0", cli_dir / "rank1"
    log = (rank0 / "scalars.jsonl").read_text()
    assert "train_losses/total" in log and "val_losses/EPE" in log
    assert len(list((rank0 / "checkpoints").glob("step_*.pt"))) == 1
    assert len(list((rank0 / "images").glob("*.png"))) == 25
    # Rank 1 writes nothing: no scalars, checkpoints or image panel.
    assert not rank1.exists() or not any(rank1.rglob("*"))
    best = [line.split("best=")[1].split()[0] for o in outs
            for line in o["stdout"].splitlines() if "best=" in line]
    assert len(best) == 2 and best[0] == best[1]
    assert np.isfinite(float(best[0]))
    # The odd val split: the ranks' shards (2 and 1 samples, per-rank
    # batch 1) together validate every sample, and the rank with fewer
    # batches does not hang the other.
    counts = [o["flow_val_counts"] for o in outs]
    assert [len(c) for c in counts] == [1, 1]
    per_rank = [c[0]["val_losses/EPE"] for c in counts]
    assert sorted(per_rank) == [1.0, 2.0]
    assert sum(per_rank) == VAL_WINDOWS


def test_traj_train_cli_two_processes_match_one(results):
    """`traj-train --mesh 2,1` on two ranks against the same command in one
    process (--mesh 1,1): the logged train loss and the validation metrics
    with test_train_traj_two_processes_match_one's rtol 1e-5; each rank
    validates its share of the eval split; rank 1 writes nothing."""
    outs = world(results, "cli")
    cli_dir = results[0]["cli_dir"]
    assert [o["traj_rc"] for o in outs] == [0, 0]
    assert outs[1]["traj_single_rc"] == 0

    def scalars(workdir):
        recs = [json.loads(line) for line in
                (cli_dir / workdir / "scalars.jsonl").read_text()
                .splitlines()]
        train = [r for r in recs if "train_losses/total" in r]
        val = [r for r in recs if "val/masked_TEPE" in r]
        assert len(train) == 1 and len(val) == 1
        return train[0], val[0]

    (train, val), (train1, val1) = scalars("traj_rank0"), \
        scalars("traj_single")
    assert np.isfinite(train["train_losses/total"])
    np.testing.assert_allclose(train["train_losses/total"],
                               train1["train_losses/total"], rtol=1e-5)
    assert set(val) == set(val1)
    for k in val1:
        np.testing.assert_allclose(val[k], val1[k], rtol=1e-5, err_msg=k)
    assert (cli_dir / "traj_rank0/checkpoints/step_1.pt").is_file()
    rank1 = cli_dir / "traj_rank1"
    assert not rank1.exists() or not any(rank1.rglob("*"))
    counts = [o["traj_val_counts"] for o in outs]
    assert [len(c) for c in counts] == [1, 1]
    assert [c[0]["val/masked_TEPE"] for c in counts] == [1.0, 1.0]


@pytest.fixture(scope="module")
def traj_loop_single(results, tmp_path_factory):
    """train_traj in this process, no mesh, on the global batches and every
    validation sample: (what it returns, the validations' metrics, the
    files it wrote)."""
    from motionpriorcmax_tpu_torch.cli.main import run_traj_validation
    from motionpriorcmax_tpu_torch.training.loop import train_traj
    from tests._torch_parallel_worker import raft_state

    inp = results[0]["steps_inputs"]
    case = inp["traj_loop"]
    vals = []

    def validate(model):
        vals.append(run_traj_validation(model, case["val"], 1,
                                        case["val_ts"]))
        return vals[-1]

    workdir = tmp_path_factory.mktemp("traj_single")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        res = train_traj(raft_state(inp), case["batches"], str(workdir),
                         max_steps=len(case["batches"]),
                         loss_cfg=FocusLossConfig(
                             **inp["raft"]["selfsup"]["loss"]),
                         log_every=1, val_every=1, validate=validate,
                         seed=case["seed"])
    written = sorted(str(p.relative_to(workdir)) for p in workdir.rglob("*")
                     if p.is_file())
    return res, vals, written


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_train_traj_two_processes_match_one(results, traj_loop_single,
                                            mesh):
    """train_traj(mesh=) on two ranks, validating every step on each
    rank's share of the samples: both ranks return what one process
    returns, see the same validation metrics as one process over every
    sample, and rank 0 alone writes, what one process writes."""
    res, vals, written = traj_loop_single
    got = [out[f"traj_loop/{mesh}"] for out in world(results, "steps")]
    assert written == ["checkpoints/index.json", "checkpoints/step_1.pt",
                       "checkpoints/step_2.pt", "scalars.jsonl"]
    assert got[0]["written"] == written and got[1]["written"] == []
    assert got[0]["result"] == got[1]["result"]
    assert got[0]["result"]["steps"] == res["steps"] == 2
    np.testing.assert_allclose(got[0]["result"]["best"], res["best"],
                               rtol=1e-5)
    assert got[0]["val"] == got[1]["val"] and len(got[0]["val"]) == 2
    for g, w in zip(got[0]["val"], vals):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("value", ["2,1", "1,4", "2", "2,1,1", "a,b", "0,2",
                                   "2,-1", " 2, 1"])
def test_parse_mesh_matches_jax(value):
    import argparse

    try:
        want = jax_parse_mesh(value)
    except argparse.ArgumentTypeError:
        with pytest.raises(argparse.ArgumentTypeError):
            parse_mesh(value)
    else:
        assert parse_mesh(value) == want


@pytest.mark.parametrize("n", [8, 11])
def test_loader_shard_order_matches_jax(n):
    """Every rank shuffles the shared order and strides it: the ranks'
    batches are disjoint and, when the world divides the dataset, JAX's;
    a training loader cuts the remainder so that every rank reads as many
    batches, a validation loader (equal_batches=False) keeps it, as JAX's
    loader does."""
    class Data:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return {"i": np.array([i])}

    def collate(samples):
        return {"i": np.concatenate([s["i"] for s in samples])}

    world_size = 2
    ours = [[b["i"].tolist() for b in DataLoader(
        Data(), 2, 0, seed=3, shard=(r, world_size), collate_fn=collate)]
        for r in range(world_size)]
    theirs = [[b["i"].tolist() for b in JaxLoader(
        Data(), 2, 0, seed=3, shard=(r, world_size), collate_fn=collate)]
        for r in range(world_size)]
    flat = [i for rank in ours for b in rank for i in b]
    assert len(flat) == len(set(flat))
    assert len(ours[0]) == len(ours[1])
    if n % world_size == 0:
        assert ours == theirs
    else:
        for o, t in zip(ours, theirs):
            assert o == t[:len(o)]
    # A validation loader keeps the remainder: JAX's batches exactly, every
    # sample once, and a length that counts them (per-rank batch 1 here,
    # so the ranks may read different numbers of batches).
    for bs in (1, 2):
        loaders = [DataLoader(Data(), bs, 0, shuffle=False, seed=3,
                              shard=(r, world_size), collate_fn=collate,
                              equal_batches=False)
                   for r in range(world_size)]
        val = [[b["i"].tolist() for b in ld] for ld in loaders]
        assert val == [[b["i"].tolist() for b in JaxLoader(
            Data(), bs, 0, shuffle=False, seed=3, shard=(r, world_size),
            collate_fn=collate)] for r in range(world_size)]
        assert [len(ld) for ld in loaders] == [len(v) for v in val]
        if bs == 1:
            assert sorted(i for rank in val for b in rank
                          for i in b) == list(range(n))

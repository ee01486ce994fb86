"""Port's traj-val slice vs the JAX package: validation step, EVIMO2 reader,
metric bank and the CLI.

Same weights on both sides (JAX init, randomized biases and norm statistics,
converted with `flax_raft_spline_to_torch`), same numpy inputs from a seed.
Metric tolerance: 1e-4 relative with a 1e-5 absolute floor (values near 0),
since the predictions agree to ~1e-5 relative (see test_torch_raft_spline)
and the metrics are means of norms and arccos of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionpriorcmax_tpu.metrics.core import MetricBank as JaxMetricBank
from motionpriorcmax_tpu.training.raft_spline import (RAFTTrainConfig,
                                                      create_raft_state)
from motionpriorcmax_tpu.training.raft_spline import \
    raft_validation_step as jax_validation_step
from motionpriorcmax_tpu_torch.metrics import MetricBank
from motionpriorcmax_tpu_torch.models.raft_spline import RAFTSplineConfig
from motionpriorcmax_tpu_torch.training.checkpoint import \
    flax_raft_spline_to_torch
from motionpriorcmax_tpu_torch.training.raft_spline import (
    create_raft_model, raft_validation_step)
from tests.test_raft_training import make_synthetic_evimo2, tiny_cfg
from tests.test_torch_raft_spline import SMALL, _randomized
from tests._one_thread import one_torch_thread  # noqa: F401


def _close(got, want, what):
    assert set(got) == set(want), (sorted(set(got) ^ set(want)), what)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("hw,flow_valid,traj_len", [
    ((32, 32), True, None),
    ((32, 32), False, None),
    ((58, 44), True, (0.5, 4.0)),          # pads to 64 x 48
], ids=["valid", "no-valid", "pad-trajlen"])
def test_validation_step_matches_jax(hw, flow_valid, traj_len):
    h, w = hw
    cfg = tiny_cfg()
    state = create_raft_state(cfg, RAFTTrainConfig(use_scheduler=False),
                              jax.random.PRNGKey(0), (32, 32))
    variables = _randomized({"params": state.params,
                             "batch_stats": state.batch_stats})
    state = state.replace(params=variables["params"],
                          batch_stats=variables["batch_stats"])
    model = create_raft_model(RAFTSplineConfig(**SMALL), "cpu")
    model.load_state_dict(flax_raft_spline_to_torch(variables), strict=True)

    rng = np.random.default_rng(7)
    m = 3
    ev = rng.normal(size=(2, cfg.nbins_total, h, w)).astype(np.float32)
    ev[:, :, : h // 3] = 0.0               # pixels without events
    batch = {"ev_repr": ev,
             "flow": rng.normal(size=(2, m, 2, h, w)).astype(np.float32)}
    if flow_valid:
        batch["flow_valid"] = rng.uniform(size=(2, m, h, w)) > 0.3
    ts = tuple(np.linspace(0, 1, m + 1)[1:].tolist())
    lo, hi = traj_len or (None, None)
    want = jax_validation_step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                               cfg, ts, lo, hi)
    got = raft_validation_step(model,
                               {k: torch.from_numpy(v) for k, v in batch.items()},
                               ts, lo, hi)
    _close(got, want, "raft_validation_step")


def test_metric_bank_matches_jax():
    rng = np.random.default_rng(8)
    steps = []
    for i in range(4):
        steps.append({"val/a": np.float32(rng.normal()),
                      "val/a__weight": np.float32(i % 2),   # empty updates
                      "val/b": np.float32(rng.normal())})
    jbank, tbank = JaxMetricBank(), MetricBank()
    for s in steps:
        jbank.update_device({k: jnp.asarray(v) for k, v in s.items()})
        tbank.update_device({k: torch.tensor(v) for k, v in s.items()})
    got, want = tbank.compute(), jbank.compute()
    assert set(got) == {"val/a", "val/b"}
    _close(got, want, "MetricBank")
    a = [s["val/a"] for s in steps if s["val/a__weight"] > 0]
    np.testing.assert_allclose(got["val/a"], np.mean(a), rtol=1e-6)
    tbank.reset()
    tbank.update_device({"val/c": torch.tensor(1.0),
                         "val/c__weight": torch.tensor(0.0)})
    assert np.isnan(tbank.compute()["val/c"])


@pytest.mark.filterwarnings("ignore")
def test_evimo2_provider_matches_jax(tmp_path):
    from motionpriorcmax_tpu.data.evimo2 import Evimo2Provider as JaxProvider
    from motionpriorcmax_tpu_torch.data.evimo2 import Evimo2Provider

    make_synthetic_evimo2(tmp_path, n_flows=3)
    kw = dict(nbins_context=41, flow_time_ms=300, provide_raw_events=True)
    jp, tp = JaxProvider(tmp_path, **kw), Evimo2Provider(tmp_path, **kw)
    assert len(tp) == len(jp) >= 1
    a, b = tp[0], jp[0]
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        elif k == "dataset_type":
            assert a[k].name == b[k].name
        else:
            assert a[k] == b[k], k


def _port_ckpt(path, cfg):
    """A reference-style Lightning checkpoint ('net.' keys) from a seeded port
    model, holding each residual norm only as `norm3` and no batch counters
    (the loader fills both)."""
    model = create_raft_model(cfg, "cpu", torch.Generator().manual_seed(5))
    sd = {f"net.{k}": v for k, v in model.state_dict().items()
          if ".downsample.1." not in k and not k.endswith("num_batches_tracked")}
    torch.save({"state_dict": sd}, path)
    return model


def _traj_val_argv(tmp_path, ckpt, device):
    return ["traj-val", *(["--device", device] if device else []),
            "--config-dir", "config/trajectory_inference",
            "experiment=raft-spline_evimo2-300ms_ours-selfsup",
            f"checkpoint={ckpt}", f"dataset.path={tmp_path / 'data'}",
            "batch_size=1", "model.num_iter.test=1", "model.bezier_degree=2"]


# A CLI test's EVIMO2 geometry: the reader's 384 x 512 cut (the model and
# the metrics take the data's resolution); 1/8 of it halves evenly three
# times, as the correlation pyramid's levels need.
CLI_HW = (64, 128)


def small_evimo2(monkeypatch, hw=CLI_HW):
    """Resize the port's EVIMO2 samples to `hw` instead of 384 x 512."""
    from motionpriorcmax_tpu_torch.data.evimo2 import Evimo2Datasubset

    init = Evimo2Datasubset.__init__

    def small_init(self, *args, **kw):
        init(self, *args, **kw)
        self.resize_hw = hw

    monkeypatch.setattr(Evimo2Datasubset, "__init__", small_init)


@pytest.mark.filterwarnings("ignore")
def test_traj_val_cli_on_cpu(tmp_path, capsys, monkeypatch):
    from motionpriorcmax_tpu_torch.cli.main import main
    from motionpriorcmax_tpu_torch.training.checkpoint import (
        extract_model_weights, load_raft_spline_weights)

    small_evimo2(monkeypatch)
    make_synthetic_evimo2(tmp_path / "data", n_flows=3)
    cfg = RAFTSplineConfig(bezier_degree=2, iters=1)
    ckpt = tmp_path / "Tab2L5.ckpt"
    ref = _port_ckpt(ckpt, cfg)
    # The loader restores every tensor under both of its names.
    loaded = create_raft_model(cfg, "cpu")
    load_raft_spline_weights(loaded, extract_model_weights(str(ckpt), "net."))
    for k, v in ref.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k

    assert main(_traj_val_argv(tmp_path, ckpt, "cpu")) == 0
    out = capsys.readouterr().out
    lines = dict(line.split(": ") for line in out.splitlines() if ": " in line)
    assert "val/masked_TEPE" in lines and "val/EPE_STEP05" in lines
    assert all(np.isfinite(float(v)) for v in lines.values())


def test_traj_val_without_cuda_exits_with_message(tmp_path, monkeypatch):
    from motionpriorcmax_tpu_torch.cli.main import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="is_available"):
        main(_traj_val_argv(tmp_path, tmp_path / "none.ckpt", None))


@pytest.mark.parametrize("name,overrides,match", [
    ("none.ckpt", [], "does not exist"),
    ("orbax_dir", [], "orbax"),
    ("Tab2L5.ckpt", ["dataset.name=dsec"], "unknown dataset"),
])
def test_traj_val_refuses_what_it_cannot_run(tmp_path, name, overrides, match):
    """A missing checkpoint (the JAX CLI would run on random weights), an
    orbax directory and a dataset other than EVIMO2 and MultiFlow stop with
    a message."""
    from motionpriorcmax_tpu_torch.cli.main import main

    (tmp_path / "orbax_dir").mkdir()
    (tmp_path / "Tab2L5.ckpt").write_bytes(b"")
    with pytest.raises(SystemExit, match=match):
        main(_traj_val_argv(tmp_path, tmp_path / name, "cpu") + overrides)


@pytest.mark.slow
@pytest.mark.filterwarnings("ignore")
def test_traj_val_cli_matches_jax_cli(tmp_path, capsys):
    """Port CLI (CPU) vs JAX CLI on the same reference-style checkpoint."""
    from motionpriorcmax_tpu.cli.main import main as jax_main
    from motionpriorcmax_tpu_torch.cli.main import main

    make_synthetic_evimo2(tmp_path / "data", n_flows=3)
    ckpt = tmp_path / "Tab2L5.ckpt"
    _port_ckpt(ckpt, RAFTSplineConfig(bezier_degree=2, iters=1))

    def run(fn, device):
        argv = _traj_val_argv(tmp_path, ckpt, device)
        assert fn(argv) == 0
        out = capsys.readouterr().out
        return {k: float(v) for k, v in (line.split(": ") for line in
                                         out.splitlines() if ": " in line)}

    _close(run(main, "cpu"), run(jax_main, None), "traj-val CLI")

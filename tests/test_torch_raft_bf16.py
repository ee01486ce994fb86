"""RAFT-Spline with compute_dtype 'bfloat16': the port against the JAX
package's bf16 model on the CPU, on the same weights (the `tiny_cfg`
geometry of tests/test_raft_training.py, weights carried over as in
tests/test_torch_raft_spline.py and tests/test_torch_raft_train.py).

Both sides round to bf16 at the same places, but a convolution sums its
products in another order in each framework (and on the card), so a value
near a bf16 rounding boundary can land one bf16 step (2^-8 relative) apart;
the norms and the GRU carry such a step on.  Tolerances, each below the JAX
package's own bound for bf16 against f32 (0.1 of the largest value,
tests/test_raft_training.py), with the margins measured on this geometry:
  * the update block: 2e-2 of each output's largest (measured 8.1e-3 net,
    4.7e-3 mask, 4.1e-3 delta);
  * the whole 2-iteration forward: 5e-2 of the largest, as the UNet's bf16
    parity test (measured 2.1e-3 / 2.3e-3 low resolution and 6.9e-4 /
    8.3e-4 upsampled, corr_dtype float32 / bfloat16);
  * one self-supervised train step: the loss to 1e-3 relative (measured
    3.9e-5), the gradient's direction: cosine >= 0.95 over all parameters
    (measured 0.983) and >= 0.9 for each tensor whose gradient reaches
    1e-2 of the model's largest (measured >= 0.957).
The bf16 forward is also held more than 1e-4 of the largest value away
from the f32 one (measured 9.6e-4 / 1.1e-3; f32 parity is 1e-5), so that
these checks do see the bf16 path.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import motionpriorcmax_tpu.training.raft_spline as jrs
from motionpriorcmax_tpu.models.raft_spline import RAFTSpline as JaxRAFT
from motionpriorcmax_tpu.models.raft_spline import \
    RAFTSplineConfig as JaxCfg
from motionpriorcmax_tpu_torch.models.raft_spline import (RAFTSpline,
                                                          RAFTSplineConfig)
from motionpriorcmax_tpu_torch.models.raft_spline.update import \
    BasicUpdateBlock
from motionpriorcmax_tpu_torch.training import raft_spline as trs
from motionpriorcmax_tpu_torch.training.checkpoint import \
    flax_raft_spline_to_torch
from motionpriorcmax_tpu_torch.training.loop import to_device
from tests.test_torch_raft_spline import (SMALL, JaxUpdate, _randomized,
                                          _rel_err, _strip, _t, _under)
from tests.test_torch_raft_train import (LOSS_KW, FocusLossConfig,
                                         JaxFocusCfg, jax_state, jax_times,
                                         port_state, selfsup_batch)
from tests.test_torch_raft_train import variables  # noqa: F401 (fixture)
from tests._one_thread import one_torch_thread  # noqa: F401

BF16 = dict(compute_dtype="bfloat16")


def test_update_block_bf16_matches_jax():
    rng = np.random.default_rng(5)
    b, h, w, param_dim, corr_ch = 2, 6, 7, 4, 3 * 81
    net, inp = (np.tanh(rng.normal(size=(b, 128, h, w))).astype(np.float32)
                for _ in range(2))
    corr = rng.normal(size=(b, corr_ch, h, w)).astype(np.float32)
    params = rng.normal(size=(b, param_dim, h, w)).astype(np.float32)
    args = [jnp.asarray(a) for a in (net, inp, corr, params)]
    variables = _randomized(jax.jit(JaxUpdate(param_dim=param_dim).init)(
        jax.random.PRNGKey(0), *args))
    want = jax.jit(JaxUpdate(param_dim=param_dim, dtype=jnp.bfloat16).apply)(
        variables, *args)
    port = BasicUpdateBlock(corr_ch, param_dim,
                            dtype=torch.bfloat16).eval()
    port.load_state_dict(_strip("update_block", flax_raft_spline_to_torch(
        _under("update_block", variables))), strict=True)
    with torch.no_grad():
        got = port(*(_t(a) for a in (net, inp, corr, params)))
    for name, g, w_ in zip(("net", "mask", "delta"), got, want):
        # The state and both heads' outputs are f32, as JAX returns them.
        assert g.dtype == torch.float32 and w_.dtype == jnp.float32, name
        assert _rel_err(g.numpy(), np.asarray(w_)) < 2e-2, name


@pytest.mark.parametrize("corr_dtype", ["float32", "bfloat16"])
def test_raft_spline_bf16_forward_matches_jax(variables, corr_dtype):  # noqa: F811
    kw = {**SMALL, **BF16, "corr_dtype": corr_dtype}
    voxel = np.random.default_rng(0).normal(size=(2, 7, 32, 32)).astype(
        np.float32)
    low_j, up_j = jax.jit(functools.partial(
        JaxRAFT(JaxCfg(**kw)).apply, test_mode=True))(variables,
                                                      jnp.asarray(voxel))
    ports = {}
    for name, cfg_kw in (("bf16", kw), ("f32", SMALL)):
        ports[name] = RAFTSpline(RAFTSplineConfig(**cfg_kw)).eval()
        ports[name].load_state_dict(flax_raft_spline_to_torch(variables),
                                    strict=True)
    with torch.no_grad():
        low_t, up_t = ports["bf16"](_t(voxel), test_mode=True)
        _, up_32 = ports["f32"](_t(voxel), test_mode=True)
    assert low_t.dtype == up_t.dtype == torch.float32
    assert _rel_err(low_t.numpy(), np.asarray(low_j)) < 5e-2
    assert _rel_err(up_t.numpy(), np.asarray(up_j)) < 5e-2
    assert _rel_err(up_t.numpy(), up_32.numpy()) > 1e-4


def test_bf16_state_dict_names_and_shapes_equal_f32():
    sd32 = RAFTSpline(RAFTSplineConfig(**SMALL)).state_dict()
    sd16 = RAFTSpline(RAFTSplineConfig(**SMALL, **BF16,
                                       corr_dtype="bfloat16")).state_dict()
    assert list(sd16) == list(sd32)
    for k, v in sd32.items():
        assert sd16[k].shape == v.shape and sd16[k].dtype == v.dtype, k


def test_raft_bf16_train_step_matches_jax(variables):  # noqa: F811
    # The named recipe: bf16 compute with a bf16 corr pyramid; f32
    # parameters and AdamW state on both sides.
    batch = selfsup_batch(1)
    jloss = JaxFocusCfg(**LOSS_KW)
    rng = jax.random.PRNGKey(3)
    cfg, jstate = jax_state(variables, 2, **BF16, corr_dtype="bfloat16")
    new_jstate, jlogs = jax.jit(lambda s, b, r: jrs.raft_train_step(
        s, b, r, cfg=cfg, loss_cfg=jloss,
        num_pos_events=batch["num_pos_events"]))(
        jstate, {k: jnp.asarray(batch[k]) for k in
                 ("ev_repr", "events", "lut_cell_ends")}, rng)
    state = port_state(variables, 2, **BF16, corr_dtype="bfloat16")
    logs = trs.raft_train_step(
        state, to_device(batch, torch.device("cpu")), None,
        FocusLossConfig(**LOSS_KW), batch["num_pos_events"],
        times=torch.tensor(np.asarray(jax_times(jloss, rng))))
    loss, jl = float(logs["train_losses/total"]), float(
        jlogs["train_losses/total"])
    assert np.isfinite(loss) and abs(loss - jl) <= 1e-3 * abs(jl)

    want = {k: v.numpy() for k, v in flax_raft_spline_to_torch(
        {"params": new_jstate.opt_state[1]}).items()}
    got = {n: p.grad.numpy() for n, p in state.model.named_parameters()}
    for n, p in state.model.named_parameters():
        assert p.dtype == torch.float32, n
    for group in state.optimizer.state.values():
        assert all(v.dtype == torch.float32 for v in group.values())

    def cos(a, b):
        return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))

    assert cos(np.concatenate([got[n].ravel() for n in got]),
               np.concatenate([want[n].ravel() for n in got])) >= 0.95
    top = max(np.abs(g).max() for g in want.values())
    live = [n for n in got if np.abs(want[n]).max() >= 1e-2 * top]
    assert live
    for n in live:
        assert cos(got[n].ravel(), want[n].ravel()) >= 0.9, n


@pytest.mark.parametrize("corr_dtype", ["float32", "bfloat16"])
def test_traj_cli_configs_accept_bf16_compute(corr_dtype):
    # traj-val's and traj-train's configs with the two overrides.
    from motionpriorcmax_tpu_torch.cli.main import (raft_config_from_tree,
                                                    traj_train_configs)
    from motionpriorcmax_tpu_torch.config import compose

    tree = compose("config/trajectory_inference", "val", [
        "experiment=raft-spline_evimo2-300ms_ours-selfsup", "checkpoint=none",
        "dataset.path=none", "model.compute_dtype=bfloat16",
        f"model.corr_dtype={corr_dtype}"])
    cfg = raft_config_from_tree(tree["model"])
    assert (cfg.compute_dtype, cfg.corr_dtype) == ("bfloat16", corr_dtype)
    cfg, _, _ = traj_train_configs(tree, (384, 512), 10)
    assert (cfg.compute_dtype, cfg.corr_dtype) == ("bfloat16", corr_dtype)

"""Port's RAFT-Spline training vs the JAX package, on the CPU, at the
`tiny_cfg` geometry of tests/test_raft_training.py (32 x 32, 5 context
bins, degree 2, targets (2, 4), levels (1, 2)).

Both sides start from the same weights (the port's init carried into the
JAX tree, biases and BatchNorm statistics randomized, back to the port
through `flax_raft_spline_to_torch`) and
get the same numpy batch (collated, polarity-packed, LUT-cell-sorted by
the port's collate).  t_ref and the gamma subsample are drawn by JAX and
handed to the port.  The JAX step runs with a wrapper around its optimizer
that keeps the raw gradients, so one jitted step gives loss, gradients,
updated weights and BatchNorm statistics.

Tolerances: loss 1e-5 relative; gradients 1e-4 of each tensor's largest
(f32 convolutions sum in another order, through 2-4 iterations, the KNN
and the vote); BatchNorm running statistics 1e-5 absolute.  AdamW's first
step moves a parameter by ~lr * sign(grad), which amplifies rounding-level
gradients: updated weights are compared (to 1% of lr) where the JAX
gradient exceeds 1e-3 of its tensor's largest.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import motionpriorcmax_tpu.training.raft_spline as jrs
from motionpriorcmax_tpu.losses import FocusLossConfig as JaxFocusCfg
from motionpriorcmax_tpu.losses import get_reconstruction_times as jax_times
from motionpriorcmax_tpu.models.raft_spline import RAFTSpline as JaxRAFT
from motionpriorcmax_tpu.models.raft_spline import curves as jcurves
from motionpriorcmax_tpu.training.checkpoint import torch_raft_spline_to_flax
from motionpriorcmax_tpu_torch.data.collate import collate_fixed_capacity
from motionpriorcmax_tpu_torch.losses import FocusLossConfig
from motionpriorcmax_tpu_torch.models.raft_spline import RAFTSplineConfig
from motionpriorcmax_tpu_torch.training import raft_spline as trs
from motionpriorcmax_tpu_torch.training.checkpoint import \
    flax_raft_spline_to_torch
from motionpriorcmax_tpu_torch.training.loop import to_device
from tests.test_raft_training import tiny_cfg
from tests.test_torch_raft_spline import SMALL, _randomized

H, W = 32, 32
LOSS_KW = dict(image_shape=(H, W), num_tref=1, num_bins=5, num_knn=4,
               smooth_weight=0.01, lut_superpixel_size=4, focus_loss_norm="l1",
               polarity_aware_batching=True, interpolation_scheme="mean",
               smooth_type="on_flow_to_next")
LR = 1e-4


def capturing(inner):
    """`inner` that also keeps the raw gradients as the second half of its
    state (so that the JAX step's gradients can be read)."""
    def init(params):
        return inner.init(params), jax.tree_util.tree_map(jnp.zeros_like,
                                                          params)

    def update(grads, state, params=None):
        updates, inner_state = inner.update(grads, state[0], params)
        return updates, (inner_state, grads)
    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def variables():
    """Weights of the tiny model (any iteration count: the parameters do
    not depend on it) for both sides: the port's seeded init carried into
    the JAX tree by the JAX package's converter (the tree's structure from
    jax.eval_shape of the JAX init, which compiles nothing), then biases
    and BatchNorm statistics randomized."""
    template = jax.eval_shape(lambda: JaxRAFT(tiny_cfg(remat_iters=False)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 7, H, W)), test_mode=True))
    port = trs.create_raft_model(RAFTSplineConfig(**SMALL), "cpu")
    return _randomized(torch_raft_spline_to_flax(
        {k: v.numpy() for k, v in port.state_dict().items()}, template))


def jax_state(variables, iters=2, **kw):
    """(cfg, state) of the JAX model on `variables`; remat off (a memory
    knob, the same function) and the optimizer wrapped by `capturing`."""
    cfg = tiny_cfg(iters=iters, remat_iters=False, **kw)
    tc = jrs.RAFTTrainConfig(use_scheduler=False, learning_rate=LR)
    state = jrs.RAFTTrainState.create(
        apply_fn=JaxRAFT(cfg).apply, params=variables["params"],
        tx=capturing(jrs.make_optimizer(tc)),
        batch_stats=variables["batch_stats"])
    return cfg, state


def port_state(variables, iters=2, **kw):
    cfg = RAFTSplineConfig(**{**SMALL, "iters": iters, **kw})
    tc = trs.RAFTTrainConfig(use_scheduler=False, learning_rate=LR)
    state = trs.create_raft_train_state(cfg, tc, "cpu")
    state.model.load_state_dict(flax_raft_spline_to_torch(variables),
                                strict=True)
    return state


def selfsup_batch(seed, b=2, n=1500, capacity=2048):
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(b):
        t = np.sort(rng.uniform(0, 1, n))
        ev = np.stack([rng.uniform(0, H - 1, n), rng.uniform(0, W - 1, n), t,
                       rng.integers(0, 2, n),
                       np.clip((t * 5).astype(np.int64), 0, 4)], -1
                      ).astype(np.float32)
        samples.append({"pos_events": ev[ev[:, 3] == 1],
                        "neg_events": ev[ev[:, 3] == 0],
                        "ev_repr": rng.normal(size=(7, H, W)).astype(np.float32)})
    return collate_fixed_capacity(samples, capacity, True,
                                  lut_cell_sort_params=((H, W), 5, 4))


def supervised_batch(seed, b=2, steps=3):
    rng = np.random.default_rng(seed)
    return {"ev_repr": rng.normal(size=(b, 7, H, W)).astype(np.float32),
            "flow": rng.normal(scale=2.0, size=(b, steps, 2, H, W)).astype(
                np.float32),
            "flow_timestamps": np.broadcast_to(np.linspace(
                0, 1, steps + 1)[1:].astype(np.float32), (b, steps)).copy(),
            "flow_valid": rng.uniform(size=(b, steps, H, W)) > 0.2}


def compare_step(new_jstate, state, before):
    """Gradients, updated weights and BatchNorm statistics, by port name.

    A tensor whose JAX gradient stays below 1e-6 of the model's largest is
    zero up to rounding (a conv bias that a norm cancels): it is held to
    1e-6 of the model's largest, not to its own."""
    grads = flax_raft_spline_to_torch({"params": new_jstate.opt_state[1]})
    after = flax_raft_spline_to_torch({"params": new_jstate.params,
                                       "batch_stats": new_jstate.batch_stats})
    top = max(float(np.abs(g.numpy()).max()) for g in grads.values())
    live = 0
    for name, p in state.model.named_parameters():
        g_j = grads[name].numpy()
        scale = max(float(np.abs(g_j).max()), 1e-2 * top)
        np.testing.assert_allclose(p.grad.numpy(), g_j, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
        mask = np.abs(g_j) > 1e-3 * scale
        np.testing.assert_allclose(
            (p.detach() - before[name]).numpy()[mask],
            (after[name] - before[name]).numpy()[mask], rtol=0,
            atol=1e-2 * LR, err_msg=name)
        live += int(mask.sum())
    assert live > 0.5 * sum(p.numel() for p in state.model.parameters())
    bn = 0
    for name, buf in state.model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), after[name].numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)
            bn += 1
    assert bn > 0


def check_logs(logs, jlogs):
    assert set(logs) == set(jlogs)
    for key in jlogs:
        np.testing.assert_allclose(float(logs[key]), float(jlogs[key]),
                                   rtol=1e-5, err_msg=key)


# (gamma, gamma_sample_k) of the self-supervised step's three modes, all
# at 4 iterations (the JAX guard sends K = 2 at 3 iterations to the full
# sum: K must be below iters - 1).
MODES = {"final": (None, None), "gamma": (0.8, None), "subsample": (0.8, 2)}
ITERS = 4
RNG = 3


@pytest.fixture(scope="module")
def jax_selfsup(variables):
    """The JAX step of every mode on one batch and key: one jit (one XLA
    compilation for the three)."""
    cfg, jstate = jax_state(variables, ITERS)
    batch = selfsup_batch(1)
    jloss = JaxFocusCfg(**LOSS_KW)

    def steps(s, b, r):
        return {mode: jrs.raft_train_step(
            s, b, r, cfg=cfg, loss_cfg=jloss,
            num_pos_events=batch["num_pos_events"], gamma=g, gamma_sample_k=k)
            for mode, (g, k) in MODES.items()}

    out = jax.jit(steps)(jstate, {key: jnp.asarray(batch[key]) for key in
                                  ("ev_repr", "events", "lut_cell_ends")},
                         jax.random.PRNGKey(RNG))
    return batch, jloss, out


@pytest.mark.parametrize("mode", list(MODES))
def test_raft_train_step_matches_jax(variables, jax_selfsup, mode):
    gamma, k = MODES[mode]
    batch, jloss, out = jax_selfsup
    new_jstate, jlogs = out[mode]
    rng = jax.random.PRNGKey(RNG)
    state = port_state(variables, ITERS)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    sample_idx = None
    if k is not None:
        # JAX's draw of the K non-final iterations.
        sample_idx = np.asarray(jax.random.choice(
            jax.random.fold_in(rng, 1), ITERS - 1, (k,), replace=False))
    logs = trs.raft_train_step(
        state, to_device(batch, torch.device("cpu")), None,
        FocusLossConfig(**LOSS_KW), batch["num_pos_events"], gamma, k,
        times=torch.tensor(np.asarray(jax_times(jloss, rng))),
        sample_idx=sample_idx)
    check_logs(logs, jlogs)
    compare_step(new_jstate, state, before)


def test_raft_supervised_train_step_matches_jax(variables):
    cfg, jstate = jax_state(variables)
    batch = supervised_batch(2)
    step = jax.jit(functools.partial(jrs.raft_supervised_train_step, cfg=cfg,
                                     gamma=0.8))
    new_jstate, jlogs = step(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                             jax.random.PRNGKey(0))
    state = port_state(variables)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    logs = trs.raft_supervised_train_step(
        state, to_device(batch, torch.device("cpu")), gamma=0.8)
    check_logs(logs, jlogs)
    compare_step(new_jstate, state, before)


@pytest.mark.parametrize("freeze_bn", [False, True])
def test_train_mode_sequences_and_batchnorm_match_jax(variables, freeze_bn):
    # return_sequences, the list of upsampled predictions, and the running
    # statistics after one train-mode forward (unchanged with freeze_bn).
    cfg, _ = jax_state(variables, freeze_bn=freeze_bn)
    voxel = np.random.default_rng(4).normal(size=(2, 7, H, W)).astype(
        np.float32)
    (p_seq, m_seq), mutated = jax.jit(functools.partial(
        JaxRAFT(cfg).apply, train=True, return_sequences=True,
        mutable=["batch_stats"]))(variables, jnp.asarray(voxel))
    # The JAX model's list output is cvx_upsample of each iteration.
    ups = [jcurves.cvx_upsample(p, m) for p, m in zip(p_seq, m_seq)]
    port = port_state(variables, freeze_bn=freeze_bn).model.train()
    with torch.no_grad():
        got_p, got_m = port(torch.from_numpy(voxel), return_sequences=True)
        port_stats = {n: b.clone() for n, b in port.state_dict().items()}
        got_ups = port(torch.from_numpy(voxel))
    assert got_p.shape == p_seq.shape and got_m.shape == m_seq.shape
    for got, want in ((got_p, p_seq), (got_m, m_seq)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    assert len(got_ups) == len(ups) == cfg.iters
    for got, want in zip(got_ups, ups):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    want_stats = flax_raft_spline_to_torch(
        {"batch_stats": mutated["batch_stats"]})
    init_stats = flax_raft_spline_to_torch(
        {"batch_stats": variables["batch_stats"]})
    for name, want in want_stats.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(port_stats[name].numpy(), want.numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)
            moved = not torch.equal(want, init_stats[name])
            assert moved != freeze_bn, name


def test_onecycle_schedule_matches_optax():
    # total_steps 100: 200 transition steps, the rise ends at update 10.
    tc = trs.RAFTTrainConfig(learning_rate=3e-4, total_steps=100)
    sched = optax.linear_onecycle_schedule(
        transition_steps=tc.total_steps + 100, peak_value=tc.learning_rate,
        pct_start=tc.pct_start, pct_final=1.0)
    model = torch.nn.Linear(2, 1)
    opt, lr_sched = trs.make_optimizer(model, tc)
    got = []
    for _ in range(210):
        got.append(opt.param_groups[0]["lr"])
        opt.step()
        lr_sched.step()
    want = [float(sched(c)) for c in range(210)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert max(got) == pytest.approx(tc.learning_rate)
    assert got[-1] == pytest.approx(tc.learning_rate * 1e-4)


def test_gradient_accumulation_matches_optax_multisteps():
    # accumulate_steps=2: no update after odd steps, AdamW on the running
    # gradient mean after even ones; the schedule advances per update.
    rng = np.random.default_rng(5)
    p0 = rng.normal(size=(3, 4)).astype(np.float32)
    grads = rng.normal(size=(6, 3, 4)).astype(np.float32)
    tc = trs.RAFTTrainConfig(learning_rate=1e-2, total_steps=20,
                             accumulate_steps=2)
    tx = jrs.make_optimizer(jrs.RAFTTrainConfig(
        learning_rate=1e-2, total_steps=20, accumulate_steps=2))
    jp = jnp.asarray(p0)
    jopt = tx.init(jp)

    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, lr_sched = trs.make_optimizer(model, tc)
    state = trs.RAFTTrainState(model=model, optimizer=opt,
                               scheduler=lr_sched, tc=tc)
    prev = p0
    for i, g in enumerate(grads):
        upd, jopt = tx.update(jnp.asarray(g), jopt, jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad(set_to_none=True)
        trs._apply_gradients(state, (model.w * torch.from_numpy(g)).sum())
        now = model.w.detach().numpy().copy()
        np.testing.assert_allclose(now, np.asarray(jp), rtol=0, atol=1e-6,
                                   err_msg=f"step {i}")
        if i % 2 == 0:
            np.testing.assert_array_equal(now, prev)
        prev = now
    assert state.step == 6 and state.mini_step == 0
    assert lr_sched.last_epoch == 3


def test_learned_curves_are_refused():
    cfg = RAFTSplineConfig(**{**SMALL, "curve_type": "LEARNED"})
    state = trs.create_raft_train_state(cfg, trs.RAFTTrainConfig(), "cpu")
    host = selfsup_batch(6)
    batch = to_device(host, torch.device("cpu"))
    with pytest.raises(ValueError, match="LEARNED"):
        trs.raft_train_step(state, batch, torch.Generator().manual_seed(0),
                            FocusLossConfig(**LOSS_KW),
                            host["num_pos_events"])
    with pytest.raises(ValueError, match="LEARNED"):
        trs.raft_supervised_train_step(
            state, to_device(supervised_batch(7), torch.device("cpu")))


def test_chip_smoke_drives_the_tab2l5_experiment():
    # chip_smoke.py carries the composed Tab2L5 experiment config as a dict
    # (the GPU machine has no yaml): the two must agree.
    import chip_smoke
    from motionpriorcmax_tpu_torch.config import compose

    want = compose("config/trajectory_inference", "val",
                   ["experiment=raft-spline_evimo2-300ms_ours-selfsup",
                    "checkpoint=none", "dataset.path=none"])
    assert chip_smoke.TAB2L5_CONFIG == want
    with open("config/trajectory_inference/experiment/"
              "raft-spline_evimo2-300ms_ours-selfsup.yaml") as fh:
        experiment = yaml.safe_load(fh)

    def leaves(tree, path=()):
        for key, val in tree.items():
            if isinstance(val, dict):
                yield from leaves(val, path + (key,))
            else:
                yield path + (key,), val

    for path, val in leaves(experiment):       # every experiment leaf as is
        node = chip_smoke.TAB2L5_CONFIG
        for key in path:
            node = node[key]
        assert node == val, path

"""Port's RAFT-Spline modules vs the JAX package, on the same weights.

Weights come from the JAX modules' own init (biases and norm statistics
randomized so that every mapped tensor matters) and reach the port through
`flax_raft_spline_to_torch`; inputs are numpy arrays from a seed.  JAX runs
on the CPU and its corr lookup takes the einsum path (a selection, the same
function as the Pallas kernel).  Tolerances: per module 1e-5 abs plus 1e-5
relative in f32 (conv and norm sums run in another order; both norms take
the variance as E[x^2] - E[x]^2, as flax does); the whole 2-iteration
forward 1e-4 relative to the output's scale (the differences pass through
the GRU and the convex upsample).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionpriorcmax_tpu.models.raft_spline import (RAFTSpline as JaxRAFT,
                                                    RAFTSplineConfig as JaxCfg)
from motionpriorcmax_tpu.models.raft_spline import corr as jcorr
from motionpriorcmax_tpu.models.raft_spline import curves as jcurves
from motionpriorcmax_tpu.models.raft_spline.extractor import \
    BasicEncoder as JaxEncoder
from motionpriorcmax_tpu.models.raft_spline.update import \
    BasicUpdateBlock as JaxUpdate
from motionpriorcmax_tpu.ops.basis import bernstein_basis as j_bernstein
from motionpriorcmax_tpu.training.checkpoint import torch_raft_spline_to_flax
from motionpriorcmax_tpu_torch.models.raft_spline import (RAFTSpline,
                                                          RAFTSplineConfig)
from motionpriorcmax_tpu_torch.models.raft_spline import corr as tcorr
from motionpriorcmax_tpu_torch.models.raft_spline import curves as tcurves
from motionpriorcmax_tpu_torch.models.raft_spline.extractor import BasicEncoder
from motionpriorcmax_tpu_torch.models.raft_spline.update import BasicUpdateBlock
from motionpriorcmax_tpu_torch.ops.basis import bernstein_basis
from motionpriorcmax_tpu_torch.training.checkpoint import \
    flax_raft_spline_to_torch
from tests._one_thread import one_torch_thread  # noqa: F401

SMALL = dict(nbins_context=5, nbins_correlation=3, bezier_degree=2,
             ev_target_indices=(2, 4), ev_levels=(1, 2), iters=2)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _randomized(variables, seed=0):
    """numpy copy of flax variables with random biases, BN affine and stats."""
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        name = path[-1].key
        leaf = np.asarray(leaf, np.float32)
        if name == "bias" or name == "mean":
            return rng.normal(scale=0.1, size=leaf.shape).astype(np.float32)
        if name == "scale":
            return (1 + rng.normal(scale=0.1, size=leaf.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(f, dict(variables))


def _under(prefix, variables):
    """Put a submodule's variables under a top-level name (fnet_ev, ...)."""
    return {coll: {prefix: tree} for coll, tree in variables.items() if tree}


def _strip(prefix, sd):
    return {k[len(prefix) + 1:]: v for k, v in sd.items()
            if k.startswith(prefix + ".")}


def test_bernstein_and_curve_flow_match_jax():
    rng = np.random.default_rng(0)
    times = np.linspace(0, 1, 7).astype(np.float32)
    np.testing.assert_allclose(
        bernstein_basis(_t(times), 10).numpy(),
        np.asarray(j_bernstein(jnp.asarray(times), 10)), rtol=1e-6, atol=1e-7)
    params = rng.normal(size=(2, 2 * 3, 4, 5)).astype(np.float32)
    for kind in ("BEZIER", "POLYNOMIAL"):
        want = np.asarray(jcurves.curve_flow_from_reference(
            jnp.asarray(params), times, kind))
        got = tcurves.curve_flow_from_reference(_t(params), times, kind)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_array_equal(tcurves.coords_grid(2, 3, 4).numpy(),
                                  np.asarray(jcurves.coords_grid(2, 3, 4)))


def test_cvx_upsample_matches_jax():
    rng = np.random.default_rng(1)
    data = rng.normal(size=(2, 4, 3, 5)).astype(np.float32)
    mask = rng.normal(size=(2, 9 * 64, 3, 5)).astype(np.float32)
    want = np.asarray(jcurves.cvx_upsample(jnp.asarray(data), jnp.asarray(mask)))
    got = tcurves.cvx_upsample(_t(data), _t(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_corr_pyramid_and_lookup_match_jax():
    rng = np.random.default_rng(2)
    b, d, h, w, t = 2, 16, 8, 8, 3
    f1 = rng.normal(size=(b, d, h, w)).astype(np.float32)
    f2 = rng.normal(size=(t, b, d, h, w)).astype(np.float32)
    levels = [1, 3, 2]
    jc = jcorr.compute_corr_volume(jnp.asarray(f1), jnp.asarray(f2))
    tc = tcorr.compute_corr_volume(_t(f1), _t(f2))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    jp = jcorr.build_corr_pyramid(jc, levels)
    tp = tcorr.build_corr_pyramid(_t(np.asarray(jc)), levels)
    for (ji, jl), (ti, tl) in zip(jp, tp):
        assert ji == ti
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6)
    coords = (np.asarray(jcurves.coords_grid(b, h, w))[None]
              + rng.normal(scale=3.0, size=(t, b, 2, h, w))).astype(np.float32)
    want = np.asarray(jcorr.lookup_corr_pyramid(jp, jnp.asarray(coords), 4))
    got = tcorr.lookup_corr_pyramid(tp, _t(coords), 4)
    assert got.shape == (b, sum(levels) * 81, h, w)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_bilinear_sample_oracle_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.normal(size=(3, 5, 6)).astype(np.float32)
    x = rng.uniform(-2, 7, (3, 10)).astype(np.float32)
    y = rng.uniform(-2, 6, (3, 10)).astype(np.float32)
    want = np.asarray(jcorr.bilinear_sample_hw(*map(jnp.asarray, (img, x, y))))
    got = tcorr.bilinear_sample_hw(_t(img), _t(x), _t(y))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("norm_fn", ["instance", "batch"])
def test_basic_encoder_matches_jax(norm_fn):
    rng = np.random.default_rng(4)
    xs = [rng.normal(size=(2, 3, 32, 40)).astype(np.float32) for _ in range(2)]
    enc = JaxEncoder(output_dim=48, norm_fn=norm_fn)
    variables = _randomized(enc.init(jax.random.PRNGKey(0),
                                     [jnp.asarray(x) for x in xs]))
    want = enc.apply(variables, [jnp.asarray(x) for x in xs])
    port = BasicEncoder(3, 48, norm_fn).eval()
    port.load_state_dict(
        _strip("cnet", flax_raft_spline_to_torch(_under("cnet", variables))),
        strict=True)
    with torch.no_grad():
        got = port([_t(x) for x in xs])
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g.shape == (2, 48, 4, 5)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_update_block_matches_jax():
    rng = np.random.default_rng(5)
    b, h, w, param_dim, corr_ch = 2, 6, 7, 4, 3 * 81
    net, inp = (np.tanh(rng.normal(size=(b, 128, h, w))).astype(np.float32)
                for _ in range(2))
    corr = rng.normal(size=(b, corr_ch, h, w)).astype(np.float32)
    params = rng.normal(size=(b, param_dim, h, w)).astype(np.float32)
    upd = JaxUpdate(param_dim=param_dim)
    args = [jnp.asarray(a) for a in (net, inp, corr, params)]
    variables = _randomized(upd.init(jax.random.PRNGKey(0), *args))
    want = upd.apply(variables, *args)
    port = BasicUpdateBlock(corr_ch, param_dim).eval()
    port.load_state_dict(_strip("update_block", flax_raft_spline_to_torch(
        _under("update_block", variables))), strict=True)
    with torch.no_grad():
        got = port(*(_t(a) for a in (net, inp, corr, params)))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5,
                                   atol=1e-5)


def _jax_and_port(cfg_kw, hw=(32, 32), seed=0):
    jcfg = JaxCfg(**cfg_kw)
    rng = np.random.default_rng(seed)
    voxel = rng.normal(size=(2, jcfg.nbins_total) + hw).astype(np.float32)
    images = None
    if jcfg.use_boundary_images:
        images = [rng.integers(0, 255, (2, 3) + hw).astype(np.float32)
                  for _ in range(2)]
    model = JaxRAFT(jcfg)
    jimgs = None if images is None else [jnp.asarray(i) for i in images]
    variables = _randomized(model.init(jax.random.PRNGKey(seed),
                                       jnp.asarray(voxel), jimgs,
                                       test_mode=True))
    port = RAFTSpline(RAFTSplineConfig(**cfg_kw)).eval()
    port.load_state_dict(flax_raft_spline_to_torch(variables), strict=True)
    return model, variables, port, voxel, images


def _rel_err(got, want):
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


@pytest.mark.parametrize("extra", [
    dict(curve_type="BEZIER"),
    dict(curve_type="LEARNED"),
    dict(curve_type="POLYNOMIAL", bezier_degree=1, ev_levels=(1, 1),
         use_boundary_images=True, img_levels=2),
], ids=["bezier", "learned", "images"])
def test_raft_spline_forward_matches_jax(extra):
    model, variables, port, voxel, images = _jax_and_port({**SMALL, **extra})
    jimgs = None if images is None else [jnp.asarray(i) for i in images]
    low_j, up_j = model.apply(variables, jnp.asarray(voxel), jimgs,
                              test_mode=True)
    with torch.no_grad():
        low_t, up_t = port(_t(voxel), None if images is None
                           else [_t(i) for i in images], test_mode=True)
    assert up_t.shape == up_j.shape
    assert _rel_err(low_t.numpy(), np.asarray(low_j)) < 1e-4
    assert _rel_err(up_t.numpy(), np.asarray(up_j)) < 1e-4


def test_state_dict_round_trip_through_jax_converter():
    """The port's state_dict read by the JAX package's torch converter gives
    the same JAX outputs: the port's names are the canonical ones."""
    model, variables, port, voxel, _ = _jax_and_port(SMALL, seed=1)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = torch_raft_spline_to_flax(sd, variables)
    _, up_a = model.apply(variables, jnp.asarray(voxel), test_mode=True)
    _, up_b = model.apply(back, jnp.asarray(voxel), test_mode=True)
    np.testing.assert_array_equal(np.asarray(up_b), np.asarray(up_a))


def test_forward_runs_f32_without_tf32_and_restores_flags(monkeypatch):
    # compute_dtype 'float32': the forward turns both TF32 flags off, whatever
    # the process set (cuDNN's default is on), and hands them back after.
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    port = RAFTSpline(RAFTSplineConfig(**SMALL)).eval()
    seen = []
    port.update_block.register_forward_pre_hook(lambda mod, inp: seen.append(
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)))
    voxel = np.random.default_rng(6).normal(size=(1, 7, 16, 16))
    with torch.no_grad():
        port(_t(voxel), test_mode=True)
    assert seen == [(False, False)] * SMALL["iters"]
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("field,value", [
    ("curve_type", "BEZEIR"), ("corr_dtype", "fp32"),
    ("compute_dtype", "half")])
def test_config_raises_on_unknown_strings(field, value):
    with pytest.raises(ValueError, match=field):
        RAFTSplineConfig(**{**SMALL, field: value})

"""Port's banded softmax interpolation (kernel row 7) vs the JAX package.

The oracle is the TPU kernel `softmax_interp_pallas` in interpret mode (its
f32 'vpu' weights and the band's scanned slots, `_tile_band`) and the dense
`softmax_interp_reference`.  JAX runs on the CPU (tests/conftest.py); inputs
are numpy arrays from a seed.  On the CPU the port's wrappers run their
plain versions; the CUDA kernels are held against those by the `cuda` test,
on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_softmax_interp.py
"""

import numpy as np
import pytest
import torch

from motionpriorcmax_tpu_torch.ops.cuda import softmax_interp as si

try:
    import jax
    import jax.numpy as jnp

    from motionpriorcmax_tpu.losses import FocusLossConfig as JaxFocusCfg
    from motionpriorcmax_tpu.losses.focus import \
        interpolate_flow as jax_interpolate_flow
    from motionpriorcmax_tpu.ops.pallas.softmax_interp import (
        softmax_interp_pallas, softmax_interp_reference)
except ImportError:         # the GPU machine: only the cuda test runs there
    jax = None

# A 70 x 30 grid of cell 4: Q = N = 2100 is no multiple of 512 or 1024, and
# the last query block (52 queries) is partial.
GH, GW, CELL = 70, 30, 4.0
TEMP = 16.0


def grid_queries():
    ys = np.arange(GH) * CELL + CELL / 2 - 0.5
    xs = np.arange(GW) * CELL + CELL / 2 - 0.5
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([gy.reshape(-1), gx.reshape(-1)], -1).astype(np.float32)


def make_inputs(seed, g=3, c=2, disp=6.0):
    """Grid queries, db = the grid displaced by up to `disp` px per group
    (growing with the group, like bin midtimes), values and a cotangent."""
    rng = np.random.default_rng(seed)
    q = grid_queries()
    db = np.stack([q + rng.uniform(-disp * (i + 1) / g, disp * (i + 1) / g,
                                   q.shape) for i in range(g)])
    vals = rng.normal(size=(g, q.shape[0], c))
    cot = rng.normal(size=(g, q.shape[0], c))
    return (q, db.astype(np.float32), vals.astype(np.float32),
            cot.astype(np.float32))


def bands(kind, db, g):
    """(numpy band for JAX, the same for the port)."""
    tail = 4.0 * np.sqrt(TEMP) + CELL
    if kind == "none":
        return (0.0, 0.0, 0.0)
    if kind == "static":
        return (20.0, CELL, float(GW))
    if kind == "narrow":
        # 4 px against displacements up to 120 px: the scanned set cuts
        # real weight, so only the same slots give the same numbers.
        return (4.0, CELL, float(GW))
    q = grid_queries()
    ydisp = np.abs(db[..., 0] - q[None, :, 0])
    if kind == "traced":
        return np.array([ydisp.max() + tail, CELL, GW], np.float32)
    if kind == "per_group":
        return np.stack([ydisp.max(1) + tail, np.full(g, CELL),
                         np.full(g, GW)], -1).astype(np.float32)
    raise ValueError(kind)


def jax_fwd_and_grad(q, db, vals, cot, band, exp_dtype=None):
    exp_dtype = exp_dtype or jnp.float32
    band_j = band if isinstance(band, tuple) else jnp.asarray(band)

    def f(v):
        out = softmax_interp_pallas(jnp.asarray(q), jnp.asarray(db), v, TEMP,
                                    True, band_j, exp_dtype)
        return jnp.sum(out * cot), out

    (_, out), dv = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jnp.asarray(vals))
    return np.asarray(out), np.asarray(dv)


def port_fwd_and_grad(q, db, vals, cot, band, exp_dtype="float32",
                      cross_impl="vpu"):
    band_t = band if isinstance(band, tuple) else torch.from_numpy(band)
    v = torch.from_numpy(vals).requires_grad_()
    out = si.softmax_interp(torch.from_numpy(q), torch.from_numpy(db), v, TEMP,
                            band_t, exp_dtype, cross_impl)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), v.grad.numpy()


@pytest.mark.parametrize("kind", ["none", "static", "narrow", "traced",
                                  "per_group"])
def test_plain_matches_pallas_interpret(kind):
    # The same f32 weights over the same scanned slots; the sums run in
    # another order (the TPU kernel adds 1024-slot tiles): forward within
    # 1e-5 of max |vals|, d vals within 1e-5 of its largest.
    disp = 120.0 if kind == "narrow" else 6.0
    q, db, vals, cot = make_inputs(0, disp=disp)
    band = bands(kind, db, db.shape[0])
    want, dv_want = jax_fwd_and_grad(q, db, vals, cot, band)
    got, dv_got = port_fwd_and_grad(q, db, vals, cot, band)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(vals).max())
    np.testing.assert_allclose(dv_got, dv_want, rtol=0,
                               atol=1e-5 * np.abs(dv_want).max())
    if kind == "narrow":
        # The band cut real weight: the full scan gives other numbers.
        full, _ = port_fwd_and_grad(q, db, vals, cot, (0.0, 0.0, 0.0))
        assert np.abs(full - got).max() > 1e-2
    if kind in ("static", "traced", "per_group"):
        # Margins that cover the displacement: the dense reference.
        ref = np.asarray(softmax_interp_reference(
            jnp.asarray(q), jnp.asarray(db), jnp.asarray(vals), TEMP))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_scan_slots_per_group_rows_and_full_range():
    # [G, 3] rows give each group its own range; margin <= 0 scans all N;
    # ranges are 1024-slot tiles clipped to N.
    q = torch.from_numpy(grid_queries())
    n = q.shape[0]
    band = torch.tensor([[0.0, CELL, GW], [4.0, CELL, GW]])
    slots = si.scan_slots(q, band, 2, n)
    assert slots.dtype == torch.int32 and tuple(slots.shape) == (2, 5, 2)
    assert (slots[0, :, 0] == 0).all() and (slots[0, :, 1] == n).all()
    lo, hi = slots[1, :, 0], slots[1, :, 1]
    assert ((lo % si.BN) == 0).all() and (hi <= n).all()
    assert ((hi == n) | (hi % si.BN == 0)).all()
    assert (lo[1:] >= lo[:-1]).all() and (hi[1:] >= hi[:-1]).all()
    assert int(hi[0]) < n and int(lo[-1]) > 0
    with pytest.raises(ValueError, match="rows"):
        si.scan_slots(q, torch.zeros(3, 3), 2, n)


def test_starved_query_gives_zero_not_nan():
    # Every db point far away: den underflows to exactly 0 (no
    # max-subtraction), the output is 0, and the gradient finite.
    rng = np.random.default_rng(3)
    q = rng.uniform(0, 8, (4, 2)).astype(np.float32)
    db = rng.uniform(5000, 6000, (1, 8, 2)).astype(np.float32)
    vals = rng.normal(size=(1, 8, 3)).astype(np.float32)
    cot = np.ones((1, 4, 3), np.float32)
    got, dv = port_fwd_and_grad(q, db, vals, cot, (0.0, 0.0, 0.0))
    want, dv_want = jax_fwd_and_grad(q, db, vals, cot, (0.0, 0.0, 0.0))
    assert np.all(got == 0.0) and np.all(want == 0.0)
    assert np.all(np.isfinite(dv)) and np.allclose(dv, dv_want)


def test_bf16_exp_matches_pallas_interpret():
    # exp_dtype bfloat16 rounds the exponent, weights, values and scaled
    # cotangents to bf16 (8 mantissa bits) on both sides; bf16 rounding of
    # the exponent can tip at different points after the f32 sums of
    # another order: 1e-2 of the largest value / gradient.
    q, db, vals, cot = make_inputs(1, g=2)
    band = bands("static", db, 2)
    want, dv_want = jax_fwd_and_grad(q, db, vals, cot, band, jnp.bfloat16)
    got, dv_got = port_fwd_and_grad(q, db, vals, cot, band, "bfloat16")
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-2 * np.abs(vals).max())
    np.testing.assert_allclose(dv_got, dv_want, rtol=0,
                               atol=1e-2 * np.abs(dv_want).max())


def test_cross_impl_mxu_is_the_difference_form_and_bad_raises():
    q, db, vals, cot = make_inputs(2, g=1)
    vpu = port_fwd_and_grad(q, db, vals, cot, (0.0, 0.0, 0.0))
    mxu = port_fwd_and_grad(q, db, vals, cot, (0.0, 0.0, 0.0),
                            cross_impl="mxu")
    for a, b in zip(vpu, mxu):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="cross_impl"):
        port_fwd_and_grad(q, db, vals, cot, (0.0, 0.0, 0.0),
                          cross_impl="auto")


def focus_trajectories(seed, b=2, n_bins=5, h=96, w=128, s=4):
    """Linear trajectories (disp = flow * t) on the LUT grid: positions at
    t_ref = 0.3 and at the bin midtimes."""
    rng = np.random.default_rng(seed)
    mid = s / 2.0 - 0.5
    gy, gx = np.meshgrid(np.arange(0, h, s) + mid, np.arange(0, w, s) + mid,
                         indexing="ij")
    seeds = np.stack([gy.reshape(-1), gx.reshape(-1)], -1).astype(np.float32)
    flow = rng.uniform(-10, 10, (b, seeds.shape[0], 2)).astype(np.float32)
    t_mid = ((np.arange(n_bins) + 0.5) / n_bins).astype(np.float32)
    at_tmid = seeds[None, None] + flow[:, None] * t_mid[None, :, None, None]
    at_tref = seeds[None, None] + flow[:, None] * np.float32(0.3)
    return at_tref.astype(np.float32), at_tmid.astype(np.float32)


@pytest.mark.parametrize("band_kw", [
    dict(interp_band_per_bin=True),
    dict(interp_band_dynamic=True),
    dict(interp_band_dynamic="per_group"),
    dict(interp_band_px=0.0),
    dict(smooth_type="on_flow_to_next"),
])
def test_focus_interpolation_matches_jax_pallas(band_kw):
    # losses/focus.py's softmax branch against the JAX Pallas branch on
    # the same trajectories: the flow LUT (and the flow to the next bin)
    # within 1e-5 of the largest flow, and the gradient that reaches the
    # trajectories through the values within 1e-5 of its largest.
    from motionpriorcmax_tpu_torch.losses import FocusLossConfig
    from motionpriorcmax_tpu_torch.losses.focus import interpolate_flow

    h, w, n_bins = 96, 128, 5
    kw = {**dict(image_shape=(h, w), num_tref=1, num_bins=n_bins,
                 knn_method="softmax", softmax_temp=TEMP,
                 interp_band_px=30.0, smooth_weight=0.003), **band_kw}
    at_tref, at_tmid = focus_trajectories(4, n_bins=n_bins, h=h, w=w)
    rng = np.random.default_rng(5)

    def jax_side(a, b):
        lut, nxt = jax_interpolate_flow(
            JaxFocusCfg(use_pallas_interp=True, **kw), a, b)
        return lut, nxt

    lut_j, nxt_j = jax.jit(jax_side)(jnp.asarray(at_tref), jnp.asarray(at_tmid))
    cot = rng.normal(size=lut_j.shape).astype(np.float32)
    g_ref, g_mid = jax.grad(lambda a, b: jnp.sum(jax_side(a, b)[0] * cot),
                            argnums=(0, 1))(jnp.asarray(at_tref),
                                            jnp.asarray(at_tmid))

    a = torch.from_numpy(at_tref).requires_grad_()
    b = torch.from_numpy(at_tmid).requires_grad_()
    lut, nxt = interpolate_flow(FocusLossConfig(**kw), a, b)
    (lut * torch.from_numpy(cot)).sum().backward()
    scale = np.abs(np.asarray(lut_j)).max()
    np.testing.assert_allclose(lut.detach().numpy(), np.asarray(lut_j),
                               rtol=0, atol=1e-5 * scale)
    if nxt_j is not None:
        np.testing.assert_allclose(nxt.detach().numpy(), np.asarray(nxt_j),
                                   rtol=0, atol=1e-5 * scale)
    else:
        assert nxt is None
    for got, want in ((a.grad, g_ref), (b.grad, g_mid)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_focus_config_refusals():
    from motionpriorcmax_tpu_torch.losses import FocusLossConfig

    with pytest.raises(ValueError, match="interp_band_dynamic"):
        FocusLossConfig(knn_method="softmax", interp_band_dynamic="global")
    with pytest.raises(ValueError, match="interp_cross"):
        FocusLossConfig(knn_method="softmax", interp_cross="auto")
    with pytest.raises(ValueError, match="interp_exp_dtype"):
        FocusLossConfig(knn_method="softmax", interp_exp_dtype="float16")


def far_inputs(seed, g=3, c=2, disp=40.0, far=0.01):
    """make_inputs with a share `far` of the db points thrown 1e5 px away
    (a trajectory that left the image); returns the per-group band rows of
    the others' displacement."""
    q, db, vals, cot = make_inputs(seed, g=g, c=c, disp=disp)
    rng = np.random.default_rng(seed + 1000)
    away = rng.random(db.shape[:2]) < far
    ydisp = np.where(away, 0.0, np.abs(db[..., 0] - q[None, :, 0]))
    db[away] = 1e5
    tail = 4.0 * np.sqrt(TEMP) + CELL
    per_group = np.stack([ydisp.max(1) + tail, np.full(g, CELL),
                          np.full(g, GW)], -1).astype(np.float32)
    return q, db, vals, cot, per_group


@pytest.mark.parametrize("exp_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["per_group", "none", "narrow"])
def test_culled_twin_equals_plain(kind, exp_dtype):
    # The kernels skip a pair when a lower bound of its prescaled squared
    # distance reaches si.CUT.  Their partition, run in PyTorch on 1% far
    # points and a last partial query block (Q = 2100), drops no nonzero
    # weight, gives the plain versions' out, den and d vals bit for bit,
    # computes at least the needed pairs and fewer than the scanned ones,
    # and counts as cull_pairs does.
    q, db, vals, cot, per_group = far_inputs(11)
    band = {"per_group": torch.from_numpy(per_group), "none": (0.0, 0.0, 0.0),
            "narrow": (4.0, CELL, float(GW))}[kind]
    qt, dbt = torch.from_numpy(q), torch.from_numpy(db)
    vt, gt = torch.from_numpy(vals), torch.from_numpy(cot)
    slots = si.scan_slots(qt, band, db.shape[0], q.shape[0])
    out, den, dv, pairs = si.softmax_interp_culled_plain(
        qt, dbt, vt, gt, TEMP, slots, exp_dtype)
    out_p, den_p = si.softmax_interp_fwd_plain(qt, dbt, vt, TEMP, slots,
                                               exp_dtype)
    dv_p = si.softmax_interp_bwd_plain(qt, dbt, gt, TEMP, slots, exp_dtype)
    assert torch.equal(out, out_p) and torch.equal(den, den_p)
    assert torch.equal(dv, dv_p)
    assert pairs["dropped"] == 0
    assert pairs["needed"] <= pairs["computed_fwd"] < pairs["scanned"]
    assert pairs["needed"] <= pairs["computed_bwd"] < pairs["scanned"]
    assert si.cull_pairs(qt, dbt, slots, TEMP, exp_dtype) == {
        k: pairs[k] for k in ("scanned", "needed", "computed_fwd",
                              "computed_bwd")}


@pytest.mark.parametrize("exp_dtype", ["float32", "bfloat16"])
def test_culled_twin_around_the_cut(exp_dtype):
    # One query against points at prescaled squared distances 120 to 160:
    # every weight from si.CUT - 1 on is 0, so the cut at si.CUT drops only
    # zeros; the twin computes every pair below the cut and equals plain.
    rscale = si._prescale(TEMP)
    d2 = np.arange(120 * 16, 160 * 16) / 16.0
    q = np.zeros((1, 2), np.float32)
    db = np.zeros((d2.size, 1, 2), np.float32)
    db[:, 0, 1] = np.sqrt(d2) / rscale
    ones = torch.ones(d2.size, 1, 1)
    qt, dbt = torch.from_numpy(q), torch.from_numpy(db)
    slots = si.scan_slots(qt, (0.0, 0.0, 0.0), d2.size, 1)
    _, den, dv, pairs = si.softmax_interp_culled_plain(
        qt, dbt, ones, ones, TEMP, slots, exp_dtype)
    _, den_p = si.softmax_interp_fwd_plain(qt, dbt, ones, TEMP, slots,
                                           exp_dtype)
    got = (dbt[:, 0, 1].double() * rscale) ** 2
    assert torch.equal(den, den_p) and torch.equal(dv[:, 0, 0], den[:, 0])
    assert not bool((den[:, 0] != 0)[got >= si.CUT - 1].any())
    assert bool((den[:, 0] != 0).any()) and pairs["dropped"] == 0
    xs = dbt[:, 0, 1] * rscale
    assert pairs["computed_fwd"] == pairs["computed_bwd"] == int(
        (xs * xs < si.CUT).sum())


def test_pairs_counter_refused_on_cpu():
    # Counting the pairs computed is a kernel's business: the plain versions
    # that CPU tensors run refuse a counter rather than ignore it.
    q, db, vals, cot = make_inputs(5, g=2)
    qt, dbt = torch.from_numpy(q), torch.from_numpy(db)
    vt, ct = torch.from_numpy(vals), torch.from_numpy(cot)
    slots = si.scan_slots(qt, (0.0, 0.0, 0.0), 2, qt.shape[0])
    pairs = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        si.softmax_interp_fwd(qt, dbt, vt, TEMP, slots, pairs=pairs)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        si.softmax_interp_bwd(qt, dbt, ct, TEMP, slots, pairs=pairs)
    assert int(pairs) == 0


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """The CUDA kernels against their plain versions on the card, for the
    full scan, a narrow band and per-group rows, f32 and bf16, on inputs
    with and without 1% far points (C = 2 and 3: rows of 4 and 6 floats);
    the backward gives the same bits in two calls, and the kernels' counting
    build gives the same values and computes the pairs that the partition's
    twin (cull_pairs) counts.

    f32 within 1e-5 of max |vals| (forward) and of the largest d vals: the
    same weights, summed in another order and with fused multiply-adds,
    and exp2 within 2 ulp of the plain version's.  bf16 within 1e-2: a
    bf16 rounding of the exponent may tip the other way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, db, vals, cot = make_inputs(7, g=3, c=2, disp=120.0)
    qf, dbf, valsf, cotf, per_group_f = far_inputs(8, c=3)
    for q, db, vals, cot, per_group in (
            (q, db, vals, cot, bands("per_group", db, 3)),
            (qf, dbf, valsf, cotf, per_group_f)):
        qt, dbt = torch.from_numpy(q).cuda(), torch.from_numpy(db).cuda()
        vt, ct = torch.from_numpy(vals).cuda(), torch.from_numpy(cot).cuda()
        for band in ((0.0, 0.0, 0.0), (4.0, CELL, float(GW)),
                     torch.from_numpy(per_group)):
            slots = si.scan_slots(qt, band, 3, qt.shape[0])
            for exp_dtype, tol in (("float32", 1e-5), ("bfloat16", 1e-2)):
                before = (si.softmax_interp_fwd.launches,
                          si.softmax_interp_bwd.launches)
                out, den = si.softmax_interp_fwd(qt, dbt, vt, TEMP, slots,
                                                 exp_dtype)
                gs = ct / torch.clamp(den, min=1e-30)[..., None]
                dv = si.softmax_interp_bwd(qt, dbt, gs, TEMP, slots,
                                           exp_dtype)
                torch.cuda.synchronize()
                assert (si.softmax_interp_fwd.launches,
                        si.softmax_interp_bwd.launches) == (before[0] + 1,
                                                            before[1] + 1)
                again = si.softmax_interp_bwd(qt, dbt, gs, TEMP, slots,
                                              exp_dtype)
                assert torch.equal(dv.view(torch.int32),
                                   again.view(torch.int32))
                out_p, den_p = si.softmax_interp_fwd_plain(
                    qt, dbt, vt, TEMP, slots, exp_dtype)
                dv_p = si.softmax_interp_bwd_plain(qt, dbt, gs, TEMP, slots,
                                                   exp_dtype)
                torch.testing.assert_close(out, out_p, rtol=0,
                                           atol=tol * float(vt.abs().max()))
                torch.testing.assert_close(den, den_p, rtol=tol, atol=1e-30)
                torch.testing.assert_close(dv, dv_p, rtol=0,
                                           atol=tol * float(dv_p.abs().max()))
                counts = torch.zeros(2, 1, dtype=torch.int64, device="cuda")
                c_out, c_den = si.softmax_interp_fwd(
                    qt, dbt, vt, TEMP, slots, exp_dtype, pairs=counts[0])
                c_dv = si.softmax_interp_bwd(qt, dbt, gs, TEMP, slots,
                                             exp_dtype, pairs=counts[1])
                assert torch.equal(c_out, out) and torch.equal(c_den, den)
                assert torch.equal(c_dv, dv)
                twin = si.cull_pairs(qt, dbt, slots, TEMP, exp_dtype)
                assert counts.view(-1).tolist() == [twin["computed_fwd"],
                                                    twin["computed_bwd"]]

"""The port's utils/profiling.py trace and ops/scatter.py against the JAX
package's, on the CPU.

  * trace's Chrome trace names a program span;
  * scatter_add_1d (values, gradient, the same bits in two calls) and
    scatter_add_direct against JAX on tests/test_scatter.py's cases.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from motionpriorcmax_tpu.ops.scatter import scatter_add_1d as jax_scatter
from motionpriorcmax_tpu.ops.scatter import \
    scatter_add_direct as jax_scatter_direct
from motionpriorcmax_tpu_torch.ops import scatter_add_1d, scatter_add_direct
from motionpriorcmax_tpu_torch.utils.profiling import scope, trace
from tests._one_thread import one_torch_thread  # noqa: F401


# -- utils/profiling.py -------------------------------------------------------

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

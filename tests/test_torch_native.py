"""The port's native host event ops (`motionpriorcmax_tpu_torch/native`)
against its NumPy twins and the JAX package's native library, as
tests/test_native.py holds the JAX package's; the DSEC reader and the
collate on both paths; and the loader's pool collate against the collate
of the producer thread.
"""

import numpy as np
import pytest
import torch

from motionpriorcmax_tpu_torch import native
from motionpriorcmax_tpu_torch.data import host_ops
from motionpriorcmax_tpu_torch.data.collate import collate_fixed_capacity
from motionpriorcmax_tpu_torch.data.loader import DataLoader

try:
    from motionpriorcmax_tpu import native as jax_native
    from motionpriorcmax_tpu.data import host_ops as jax_host
except ImportError:         # the GPU machine: only the cuda test runs there
    jax_native = None

pytestmark = pytest.mark.skipif(
    not (native.available() and (jax_native is None
                                 or jax_native.available())),
    reason="no host C++ compiler")

H, W, NB, S = 48, 64, 5, 4


def make_events(rng, n, h=H, w=W, nb=NB):
    t = np.sort(rng.uniform(0, 1, n))
    return np.stack([rng.uniform(0, h - 1, n), rng.uniform(0, w - 1, n), t,
                     rng.integers(0, 2, n),
                     np.clip(np.searchsorted(np.linspace(0, 1, nb + 1), t) - 1,
                             0, None)], -1).astype(np.float32)


def test_built_into_the_port_and_counted():
    assert native.build_error() is None
    assert native.build().parent.name == "_build"
    before = native.calls["lower_bound"]
    t = np.arange(10, dtype=np.int64)
    assert native.lower_bound(t, 4) == 4
    assert native.calls["lower_bound"] == before + 1
    with native.numpy_only():
        assert not native.available()
    assert native.available()


def test_lower_bound_matches_searchsorted_and_jax(rng):
    t = np.sort(rng.integers(0, 10000, 500)).astype(np.int64)
    for v in (0, 5000, 9999, 20000, int(t[100]), -1):
        want = int(np.searchsorted(t, v, "left"))
        assert native.lower_bound(t, v) == want == jax_native.lower_bound(t, v)


def test_voxelize_trilinear_matches_jax_and_numpy_twin(rng):
    # Bit for bit the JAX package's native vote (the same f32 code); the
    # NumPy twin sums in f64: within 2e-3, as tests/test_native.py holds
    # the JAX native vote to its NumPy path.
    m = 3000
    x = rng.uniform(-1, W + 1, m).astype(np.float32)
    y = rng.uniform(-1, H + 1, m).astype(np.float32)
    t = rng.uniform(0, NB - 1, m).astype(np.float32)
    p = rng.integers(0, 2, m).astype(np.float32)
    got = native.voxelize_trilinear(x, y, t, p, NB, H, W)
    np.testing.assert_array_equal(
        got, jax_native.voxelize_trilinear(x, y, t, p, NB, H, W))
    twin = host_ops._voxel_grid_tnorm_numpy(x, y, t, p, NB, H, W)
    np.testing.assert_allclose(got, twin, atol=2e-3)


def test_voxelize_temporal_matches_jax_and_loop(rng):
    x = rng.integers(-2, W + 2, 400).astype(np.int32)
    y = rng.integers(0, H, 400).astype(np.int32)
    t = rng.uniform(0, NB - 1, 400).astype(np.float32)
    p = rng.integers(0, 2, 400).astype(np.float32)
    got = native.voxelize_temporal(x, y, t, p, NB, H, W)
    np.testing.assert_array_equal(
        got, jax_native.voxelize_temporal(x, y, t, p, NB, H, W))
    want = np.zeros((NB, H, W))
    for xi, yi, ti, pi in zip(x, y, t, p):
        if not 0 <= xi < W:
            continue
        t0 = int(np.floor(ti))
        for tt in (t0, t0 + 1):
            if 0 <= tt < NB:
                want[tt, yi, xi] += (2 * pi - 1) * (1 - abs(tt - ti))
    np.testing.assert_allclose(got, want, atol=2e-3)


@pytest.mark.parametrize("npos", [-1, 1500])
def test_lut_cell_sort_native_equals_numpy_twin_and_jax(npos, rng):
    # The stable counting sort and the stable argsort give the same rows
    # and run ends; padding rows (all zero) all land in cell 0.
    ev = np.zeros((3000, 6), np.float32)
    ev[:2800, :5] = make_events(rng, 2800)
    ev[:2800, 5] = 1.0
    before = native.calls["lut_cell_sort_segment"]
    got = host_ops.lut_cell_sort(ev, (H, W), NB, S, num_pos_events=npos)
    assert native.calls["lut_cell_sort_segment"] == before + (
        1 if npos < 0 else 2)
    with native.numpy_only():
        twin = host_ops.lut_cell_sort(ev, (H, W), NB, S, num_pos_events=npos)
    ref = jax_host.lut_cell_sort(ev, (H, W), NB, S, num_pos_events=npos)
    for want in (twin, ref):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].dtype == want[1].dtype == np.int32


def test_host_voxelize_native_equals_jax(rng):
    # The DSEC loader's normalized voxel grid: bit for bit the JAX
    # package's (both native); the NumPy twin within 1e-5 after the
    # normalization.
    ev = make_events(rng, 5000)
    ev = np.concatenate([ev, np.ones((5000, 1), np.float32)], axis=1)
    ev[-100:, 5] = 0.0
    got = host_ops.voxelize_normalized_host(ev, NB, H, W)
    np.testing.assert_array_equal(
        got, jax_host.voxelize_normalized_host(ev, NB, H, W))
    with native.numpy_only():
        twin = host_ops.voxelize_normalized_host(ev, NB, H, W)
    np.testing.assert_allclose(got, twin, rtol=0, atol=1e-5)


def test_dsec_pack_native_equals_jax_and_numpy_twin(tmp_path):
    from motionpriorcmax_tpu.data.dsec import DsecSequence as JaxSequence
    from motionpriorcmax_tpu_torch.data.dsec import DsecSequence
    from tests.test_data_dsec import make_synthetic_dsec_sequence

    path = make_synthetic_dsec_sequence(tmp_path, n_events=20000)
    port = DsecSequence(path, "train", num_bins=15)
    ref = JaxSequence(path, "train", num_bins=15)
    # A rectify map with sub-pixel offsets and pixels mapped out of the
    # image, on both readers.
    rng = np.random.default_rng(3)
    rect = port.rectify_ev_map + rng.uniform(-0.6, 0.6,
                                             port.rectify_ev_map.shape)
    rect[:5] = -3.0
    port.rectify_ev_map = ref.rectify_ev_map = rect.astype(np.float32)
    ev = port.event_slicer.get_events(*map(int, port.timestamps_flow[0]))
    before = native.calls["pack_dsec_events"]
    got = port._pack_events(ev)
    assert native.calls["pack_dsec_events"] == before + 1
    np.testing.assert_array_equal(got, ref._pack_events(ev))
    with native.numpy_only():
        twin = port._pack_events(ev)
    assert got.shape == twin.shape and len(got) < len(ev["t"])
    np.testing.assert_allclose(got[:, [0, 1, 3]], twin[:, [0, 1, 3]],
                               atol=1e-5)
    np.testing.assert_allclose(got[:, 2], twin[:, 2], atol=1e-6)
    np.testing.assert_array_equal(got[:, 4], twin[:, 4])


class _Samples:
    """In-memory DSEC-like samples made from a numpy seed (made up front:
    `native.numpy_only()` in one thread would reach the others)."""

    def __init__(self, n, n_events=2500, voxel=True):
        self.samples = []
        for i in range(n):
            ev = make_events(np.random.default_rng(100 + i), n_events + 37 * i)
            s = {"pos_events": ev[ev[:, 3] == 1],
                 "neg_events": ev[ev[:, 3] == 0],
                 "file_index": np.asarray(i, np.int64), "name": f"s{i}"}
            if voxel:
                s["voxel"] = host_ops.voxelize_normalized_host(ev, NB, H, W)
            self.samples.append(s)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


@pytest.mark.parametrize("sort", [True, False])
def test_loader_pool_collate_equals_producer_collate(sort):
    # The pool collate (each sample padded, packed and sorted on a pool
    # thread, native) gives the batches of the producer-thread collate of
    # the NumPy twins: same order, same bytes.
    ds = _Samples(7)
    params = ((H, W), NB, S) if sort else None
    kw = dict(batch_size=3, capacity=4096, polarity_aware=True, seed=4,
              num_workers=4, drop_last=False)

    def producer_collate(samples):
        with native.numpy_only():
            return collate_fixed_capacity(samples, 4096, True,
                                          lut_cell_sort_params=params)

    for epoch in range(2):
        before = native.calls["lut_cell_sort_segment"]
        got = list(DataLoader(ds, lut_cell_sort_params=params, **kw))
        old = list(DataLoader(ds, collate_fn=producer_collate, **kw))
        assert native.calls["lut_cell_sort_segment"] >= before + (
            14 if sort else 0)
        assert len(got) == len(old) == 3
        for a, b in zip(got, old):
            assert a.keys() == b.keys()
            assert ("lut_cell_ends" in a) == sort and "voxel" in a
            for k in a:
                if isinstance(a[k], np.ndarray):
                    assert a[k].dtype == b[k].dtype, k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                else:
                    assert a[k] == b[k], k


def test_loader_reraises_a_sample_error():
    class Broken(_Samples):
        def __getitem__(self, i):
            if i == 4:
                raise KeyError("sample 4")
            return super().__getitem__(i)

    with pytest.raises(KeyError, match="sample 4"):
        list(DataLoader(Broken(7, voxel=False), batch_size=2, capacity=4096,
                        polarity_aware=True, shuffle=False, num_workers=2))


@pytest.mark.cuda
def test_pinned_batches_copy_to_the_card():
    # pin_memory stacks into page-locked memory; to_device copies such an
    # array as it is and stages any other through pinned memory.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from motionpriorcmax_tpu_torch.training.loop import to_device

    ds = _Samples(4, voxel=False)
    kw = dict(batch_size=2, capacity=4096, polarity_aware=True,
              lut_cell_sort_params=((H, W), NB, S), shuffle=False)
    pinned = list(DataLoader(ds, pin_memory=True, **kw))
    plain = list(DataLoader(ds, **kw))
    for a, b in zip(pinned, plain):
        assert torch.from_numpy(a["events"]).is_pinned()
        assert not torch.from_numpy(b["events"]).is_pinned()
        da, db = to_device(a, torch.device("cuda")), to_device(
            b, torch.device("cuda"))
        torch.cuda.synchronize()
        for k in da:
            assert torch.equal(da[k].cpu(), torch.from_numpy(b[k])), k
            assert torch.equal(db[k].cpu(), torch.from_numpy(b[k])), k

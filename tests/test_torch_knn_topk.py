"""The fused distance + top-K kernel of the exact KNN (ops/cuda/knn_topk.py,
csrc/knn_topk.cu) against the values its plain version ranks by.

On the CPU: the wrapper's argument checks (tensors on the `meta` device take
the kernel's path up to the launch, so its checks run here too), and
`card_cases.check_knn`, the card's oracle (the card tests' and
chip_smoke.py's phase 48), on the kernel's rule written in PyTorch and on
breaches of it.  On the card the `cuda` tests hold the kernel to
`check_knn` at small shapes, K > N, a query count that is no multiple of
the block's tile, l1, K above 64 (passes of 64), more groups than one
launch takes, and the flow-training and traj-train shapes (G = 210,
Q = N = 19,200; G = 246, Q = N = 12,288) on `card_cases.knn_case`'s
trajectories, made as tests/test_torch_focus_loss.py::make_trajectories
makes them, each with exact duplicates planted among the points:

    python -m pytest --noconftest -m cuda tests/test_torch_knn_topk.py

No JAX here: the card tests run with `--noconftest` on the GPU machine.
"""

import numpy as np
import pytest
import torch

from card_cases import check_knn, knn_case
from motionpriorcmax_tpu_torch.device import no_tf32
from motionpriorcmax_tpu_torch.ops import knn
from motionpriorcmax_tpu_torch.ops.cuda import knn_topk as kt


@pytest.mark.parametrize("case", ["dims", "d3", "dtype", "noncontiguous",
                                  "devices", "meta", "norm", "k0"])
def test_argument_checks_raise(case):
    q = torch.zeros(10, 2)
    db = torch.zeros(3, 20, 2)
    meta = {"device": "meta"}
    args, err = {
        "dims": ((q[None], db), ValueError),
        "d3": ((torch.empty(10, 3, **meta), torch.empty(3, 20, 3, **meta)),
               ValueError),
        "dtype": ((q.double(), db), TypeError),
        "noncontiguous": ((torch.empty(2, 10, **meta).t(),
                           torch.empty(3, 20, 2, **meta)), ValueError),
        "devices": ((q, torch.empty(3, 20, 2, **meta)), ValueError),
        "meta": ((torch.empty(10, 2, **meta), torch.empty(3, 20, 2, **meta)),
                 ValueError),
        "norm": ((q, db), ValueError),
        "k0": ((q, db), ValueError),
    }[case]
    kw = {"norm": "l3"} if case == "norm" else {}
    before = kt.knn_topk.launches
    with pytest.raises(err):
        kt.knn_topk(*args, 0 if case == "k0" else 8, **kw)
    assert kt.knn_topk.launches == before


def lower_index_reference(queries, database, k, norm):
    """The kernel's rule in PyTorch: the first K of a stable sort of each
    row's values (ties to the lower index, in index order), l2 distances
    refined by direct subtraction."""
    with no_tf32():
        v = kt.pairwise_dist(queries, database, norm)
    idx = torch.sort(v, dim=-1, stable=True).indices[..., :k]
    if norm == "l1":
        return idx, torch.gather(v, 2, idx)
    sel = database[torch.arange(database.shape[0])[:, None, None], idx]
    diffs = queries[None, :, None, :] - sel
    return idx, torch.sum(diffs * diffs, dim=-1)


@pytest.mark.parametrize("norm", ["l2", "l1"])
def test_check_knn_passes_the_rule_and_fails_its_breaches(norm):
    """check_knn, the card tests' oracle, on the CPU: it passes the
    lower-index selection and fails a tie taken at a higher index, equal
    values out of index order, a distance one ulp off, and a point that is
    not among the K nearest."""
    q, db = knn_case(3, 1, 2, 40, 64)
    q, db = torch.from_numpy(q), torch.from_numpy(db)
    k = 12
    idx, dist = lower_index_reference(q, db, k, norm)
    ties, _ = check_knn(q, db, k, norm, idx, dist)
    assert ties > 0, "no tie planted at the K-th value"
    with no_tf32():
        v = kt.pairwise_dist(q, db, norm)
    srt = torch.sort(v, dim=-1, stable=True)
    tie = srt.values[..., k - 1] == srt.values[..., k]
    gi, qi = [int(t[0]) for t in tie.nonzero(as_tuple=True)]
    higher = idx.clone()
    higher[gi, qi, k - 1] = srt.indices[gi, qi, k]
    dup = (srt.values[..., 1:k] == srt.values[..., :k - 1]).nonzero()[0]
    swapped = idx.clone()
    g2, q2, j = (int(t) for t in dup)
    swapped[g2, q2, j], swapped[g2, q2, j + 1] = idx[g2, q2, j + 1], \
        idx[g2, q2, j]
    ulp = dist.clone()
    ulp[0, 0, 0] = torch.nextafter(ulp[0, 0, 0], torch.tensor(1e9))
    far = idx.clone()
    far[0, 0, 0] = srt.indices[0, 0, -1]
    for bad_idx, bad_dist in ((higher, dist), (swapped, dist), (idx, ulp),
                              (far, dist)):
        with pytest.raises(AssertionError):
            check_knn(q, db, k, norm, bad_idx, bad_dist)


def test_knn_blocked_is_the_wrapper_on_cpu():
    q, db = knn_case(4, 1, 3, 24, 32)
    q, db = torch.from_numpy(q), torch.from_numpy(db)
    before = kt.knn_topk.launches
    for norm in ("l2", "l1"):
        a = knn.knn_blocked(q, db, 40, norm=norm, method="approx")
        b = kt.knn_topk_plain(q, db, 40, norm=norm)
        assert a[0].shape == (3, q.shape[0], 40)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert kt.knn_topk.launches == before


def card_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (3, 1000, 1000, 32, "l2"),     # G, Q, N, K, norm
    (3, 1000, 1000, 32, "l1"),
    (2, 300, 20, 32, "l2"),        # K > N
    (5, 777, 1500, 32, "l2"),      # Q no multiple of the block's tile
    (2, 1000, 1000, 7, "l2"),      # the 16-slot list, padded
    (2, 1000, 1000, 50, "l2"),     # the 64-slot list
    (2, 500, 1000, 100, "l2"),     # two passes: 64 + 36
    (2, 300, 700, 200, "l1"),      # four passes: 64 + 64 + 64 + 8
    (2, 100, 90, 128, "l2"),       # K > N = 90: 64 + 26
    (70000, 40, 50, 8, "l2"),      # two chunks of groups: 65,535 + 4,465
])
def test_kernel_matches_plain_on_card(shape):
    card_or_skip()
    g, nq, n, k, norm = shape
    rng = np.random.default_rng(nq + n + k)
    q = rng.uniform(0, 130, (nq, 2)).astype(np.float32)
    db = rng.uniform(0, 130, (g, n, 2)).astype(np.float32)
    db[:, 1::16] = db[:, 0::16][:, :db[:, 1::16].shape[1]]
    q, db = torch.from_numpy(q).cuda(), torch.from_numpy(db).cuda()
    before = kt.knn_topk.launches
    idx, dist = kt.knn_topk(q, db, k, norm=norm)
    torch.cuda.synchronize()
    assert kt.knn_topk.launches == before + 1
    ties, _ = check_knn(q, db, k, norm, idx, dist)
    if k < n:
        assert ties > 0, "no tie at the K-th value to test the rule on"
    i2, d2 = kt.knn_topk(q, db, k, norm=norm)
    assert torch.equal(idx, i2) and torch.equal(dist, d2)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["flow", "traj"])
def test_kernel_at_the_path_shapes_on_card(path):
    """The flow-training step's KNN (B = 14 x 15 bins, 480 x 640: G = 210,
    Q = N = 19,200) and the traj-train step's (B = 6 x 41 bins, 384 x 512:
    G = 246, Q = N = 12,288), K = 32, knn_blocked as the loss calls it."""
    card_or_skip()
    b, nb, h, w = (14, 15, 480, 640) if path == "flow" else (6, 41, 384, 512)
    q, db = knn_case(5, b, nb, h, w)
    q, db = torch.from_numpy(q).cuda(), torch.from_numpy(db).cuda()
    idx, dist = knn.knn_blocked(q, db, 32)
    torch.cuda.synchronize()
    ties, topk_lower = check_knn(q, db, 32, "l2", idx, dist)
    assert ties > 0
    print(f"[{path}] rows with a tie at the K-th value: {ties}, torch.topk "
          f"takes the lower indices in {topk_lower} of them")

"""The port's capacity buckets (collate, loader, --event-capacity-buckets)
and its error calculators vs the JAX package, on the CPU."""

import argparse

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from motionpriorcmax_tpu.cli.main import _parse_buckets as jax_parse
from motionpriorcmax_tpu.data.collate import (
    collate_fixed_capacity as jax_collate)
from motionpriorcmax_tpu.data.collate import round_up_capacity as jax_round
from motionpriorcmax_tpu.metrics.error_calculator import (
    make_error_calculator as jax_calculator)
from motionpriorcmax_tpu_torch.cli.main import main, parse_buckets
from motionpriorcmax_tpu_torch.data.collate import (bucket_capacities,
                                                    round_up_capacity)
from motionpriorcmax_tpu_torch.data.loader import DataLoader
from motionpriorcmax_tpu_torch.metrics import make_error_calculator
from tests.test_torch_focus_loss import make_events

BUCKETS = (256, 512, 1024)


def samples(seed, counts, polarity_aware):
    rng = np.random.default_rng(seed)
    out = []
    for n in counts:
        ev = make_events(rng, n)
        s = {"file_index": np.asarray(n)}
        if polarity_aware:
            s["pos_events"] = ev[ev[:, 3] == 1]
            s["neg_events"] = ev[ev[:, 3] == 0]
        else:
            s["events"] = ev
        out.append(s)
    return out


def test_round_up_capacity_matches_jax():
    for n in (0, 1, 255, 256, 257, 700, 1024, 5000):
        assert round_up_capacity(n, BUCKETS) == jax_round(n, BUCKETS)
    assert round_up_capacity(5000, BUCKETS) == 1024


@pytest.mark.parametrize("polarity_aware", [False, True])
@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("counts", [(100, 200), (300, 90), (900, 2000)])
def test_bucketed_collate_matches_jax(polarity_aware, sort, counts):
    # The loader's batch pads to the smallest bucket covering its largest
    # sample (each polarity half from the buckets halved): the same arrays
    # as JAX's bucketed collate, cell-sorted or not; the last bucket
    # truncates.
    batch_in = samples(sum(counts), counts, polarity_aware)
    sort_params = ((32, 48), 15, 4) if sort else None
    (got,) = list(DataLoader(batch_in, batch_size=len(counts),
                             capacity=4096, shuffle=False, num_workers=1,
                             polarity_aware=polarity_aware,
                             capacity_buckets=BUCKETS,
                             lut_cell_sort_params=sort_params))
    want = jax_collate(batch_in, 4096, polarity_aware,
                       capacity_buckets=BUCKETS,
                       lut_cell_sort_params=sort_params)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
    m = got["events"].shape[1]
    cap, pos = bucket_capacities(batch_in, BUCKETS, polarity_aware)
    assert m == cap
    if polarity_aware:
        assert got["num_pos_events"] == pos and pos in (128, 256, 512)
        assert m - pos in (128, 256, 512)
    else:
        assert m == BUCKETS[min(np.searchsorted(BUCKETS, max(counts)), 2)]
        assert got["events"][..., 5].sum() == sum(min(n, m) for n in counts)


def test_loader_with_buckets_matches_jax_collate():
    # The loader prepares each sample on its pool once the batch's
    # capacity is known: its batches are JAX's bucketed collate of the same
    # samples.
    data = samples(9, (100, 600, 300, 50), True)
    loader = DataLoader(data, batch_size=2, capacity=4096, shuffle=False,
                        num_workers=2, polarity_aware=True,
                        capacity_buckets=BUCKETS,
                        lut_cell_sort_params=((32, 48), 15, 4))
    batches = list(loader)
    assert len(batches) == 2
    for i, got in enumerate(batches):
        want = jax_collate(data[2 * i:2 * i + 2], 4096, True,
                           capacity_buckets=BUCKETS,
                           lut_cell_sort_params=((32, 48), 15, 4))
        assert got["num_pos_events"] == want["num_pos_events"]
        for key in ("events", "lut_cell_ends", "file_index"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert [b["events"].shape[1] for b in batches] == [
        bucket_capacities(data[:2], BUCKETS, True)[0],
        bucket_capacities(data[2:], BUCKETS, True)[0]]


@pytest.mark.parametrize("value", ["256,512,1024", "7", "1,1,2"])
def test_parse_buckets_matches_jax(value):
    assert parse_buckets(value) == jax_parse(value)


@pytest.mark.parametrize("value,match", [
    ("256,x", "comma-separated integers"), ("", "comma-separated integers"),
    ("512,256", "positive and ascending"), ("0,256", "positive and ascending"),
    ("-1", "positive and ascending")])
def test_parse_buckets_errors_match_jax(value, match, capsys):
    # The same errors as JAX's parser; on the command line argparse exits
    # with its usage message.
    for parse in (parse_buckets, jax_parse):
        with pytest.raises(argparse.ArgumentTypeError, match=match):
            parse(value)
    with pytest.raises(SystemExit):
        main(["flow-train", "--config", "x.yaml", "--device", "cpu",
              "--event-capacity-buckets", value])
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("dataset", ["DSEC", "MVSEC"])
def test_error_calculator_matches_jax(dataset):
    # EPE / nPE / AE over GT-valid pixels; MVSEC scales both flows by the
    # batch's time_scale.  rtol 1e-5 (f32 reductions in another order).
    rng = np.random.default_rng(2)
    gt = rng.normal(0, 3, (2, 2, 24, 32)).astype(np.float32)
    gt[0, :, :3] = 0.0
    pred = (gt + rng.normal(0, 1, gt.shape)).astype(np.float32)
    valid = rng.uniform(size=(2, 24, 32)) < 0.7
    scale = np.asarray([0.5, 2.0], np.float32)
    batch = {"forward_flow": gt, "flow_valid": valid, "time_scale": scale}
    want = jax_calculator(dataset).run(
        {"flow": jnp.asarray(pred)},
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_error_calculator(dataset).run(
        {"flow": torch.from_numpy(pred)},
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want) == {"EPE", "1PE", "2PE", "3PE", "AE"}
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, err_msg=key)
    gt_only = {"gt_flow": torch.from_numpy(gt)}
    assert np.isfinite(float(make_error_calculator(dataset).run(
        {"flow": torch.from_numpy(pred)}, gt_only)["EPE"]))
    with pytest.raises(ValueError, match="unknown dataset"):
        make_error_calculator("KITTI")

"""The port's DSEC flow PNG writer, reader and magnitude cap vs the JAX
package's (utils/png16.py, utils/flow_io.py), on the CPU."""

import numpy as np
import pytest

from motionpriorcmax_tpu.utils import flow_io as jio
from motionpriorcmax_tpu.utils.png16 import write_png16_rgb as jax_write
from motionpriorcmax_tpu_torch.utils import flow_io as tio
from motionpriorcmax_tpu_torch.utils.png16 import read_png_rgb, write_png16_rgb


def test_write_png16_rgb_same_bytes_as_jax(tmp_path):
    # Filter 0 and zlib level 6 on both sides: the files are equal byte
    # for byte, and the port's reader gives the array back.
    arr = np.random.default_rng(0).integers(0, 1 << 16, (37, 53, 3)
                                            ).astype(np.uint16)
    write_png16_rgb(tmp_path / "port.png", arr)
    jax_write(tmp_path / "jax.png", arr)
    assert ((tmp_path / "port.png").read_bytes()
            == (tmp_path / "jax.png").read_bytes())
    np.testing.assert_array_equal(read_png_rgb(tmp_path / "port.png"), arr)
    with pytest.raises(ValueError, match="uint16"):
        write_png16_rgb(tmp_path / "bad.png", arr.astype(np.int32))


@pytest.mark.parametrize("with_valid", [False, True])
def test_flow_png_and_scale_match_jax(tmp_path, with_valid):
    # Flows up to ~100 px, some beyond the 60 px cap: the cap, the PNG
    # bytes and the decoded flow equal JAX's; the round trip is within the
    # 1/128 px quantization.
    rng = np.random.default_rng(1)
    flow = (rng.normal(0, 30, (2, 48, 64))).astype(np.float32)
    valid = rng.uniform(size=(48, 64)) < 0.5 if with_valid else None
    capped = tio.scale_optical_flow(flow, 60)
    np.testing.assert_array_equal(capped, jio.scale_optical_flow(flow, 60))
    assert np.sqrt((capped ** 2).sum(0)).max() <= 60 + 1e-4
    assert (np.sqrt((flow ** 2).sum(0)) > 60).any()

    tio.save_flow_png(tmp_path / "port.png", capped, valid)
    jio.save_flow_png(tmp_path / "jax.png", capped, valid)
    assert ((tmp_path / "port.png").read_bytes()
            == (tmp_path / "jax.png").read_bytes())
    got, got_valid = tio.load_flow_png(tmp_path / "port.png")
    want, want_valid = jio.load_flow_png(tmp_path / "jax.png")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_valid, want_valid)
    assert np.abs(got - capped).max() <= 1 / 128
    if with_valid:
        np.testing.assert_array_equal(got_valid, valid)

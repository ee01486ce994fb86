"""Epoch-end image panels of flow training (JAX: utils/image_logging.py).

The reference's sanity image (src/utils/logging.py): for N_SAMPLES evenly
spaced samples, the unwarped event image, the GT-flow-warped IWE, the
predicted IWE, the GT flow and the predicted flow.  Each image is written
as an 8-bit RGB PNG `<workdir>/images/<step:06d>_<name>.png` by the port's
own encoder (utils/png16.py), and to a TensorBoard writer when one is
given.  A write that fails raises.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

from .png16 import write_png8_rgb
from .visualization import flow_to_rgb, normalize_iwe

N_SAMPLES = 5


class ImagePanelLogger:
    """Writes the panel images of flow-training runs."""

    def __init__(self, workdir: str, tb_writer=None):
        self.dir = Path(workdir) / "images"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.tb = tb_writer

    def _write(self, name: str, step: int, image: np.ndarray) -> None:
        """image: [H, W, 3] or [H, W] (grey, stacked to RGB) uint8."""
        if image.ndim == 2:
            image = np.stack([image] * 3, axis=-1)
        name = name.replace("/", "_")
        if self.tb is not None:
            self.tb.add_image(name, image, step, dataformats="HWC")
        write_png8_rgb(self.dir / f"{step:06d}_{name}.png", image)

    def log_panel(self, step: int, split: str, index: int, *,
                  unwarped_iwe: Optional[np.ndarray] = None,
                  pred_iwe: Optional[np.ndarray] = None,
                  gt_iwe: Optional[np.ndarray] = None,
                  pred_flow: Optional[np.ndarray] = None,
                  gt_flow: Optional[np.ndarray] = None) -> None:
        """One sample's panel, the reference's names and order: 0_unwarped,
        1_gt_iwe, 2_iwe, 3_gt_flow, 4_flow.  IWEs are min-max normalized
        and inverted."""
        prefix = f"{index:02d}_{split}"
        if unwarped_iwe is not None:
            self._write(f"{prefix}0_unwarped", step,
                        normalize_iwe(unwarped_iwe, invert=True))
        if gt_iwe is not None:
            self._write(f"{prefix}1_gt_iwe", step,
                        normalize_iwe(gt_iwe, invert=True))
        if pred_iwe is not None:
            self._write(f"{prefix}2_iwe", step,
                        normalize_iwe(pred_iwe, invert=True))
        if gt_flow is not None:
            self._write(f"{prefix}3_gt_flow", step, flow_to_rgb(gt_flow))
        if pred_flow is not None:
            self._write(f"{prefix}4_flow", step, flow_to_rgb(pred_flow))


def log_flow_epoch_images(panel: ImagePanelLogger, dataset, collate_fn,
                          render_fn: Callable[[Dict], Dict[str, np.ndarray]],
                          step: int, split: str,
                          n_samples: int = N_SAMPLES) -> None:
    """Render and write `n_samples` evenly spaced samples of `dataset`, each
    collated alone by `collate_fn([sample])`.

    render_fn(batch) -> a dict with some of unwarped_iwe, pred_iwe, gt_iwe
    ([H, W]) and pred_flow, gt_flow ([2, H, W]), numpy."""
    n = len(dataset)
    indices = np.linspace(0, n - 1, n_samples, dtype=int)
    for i, data_idx in enumerate(indices):
        batch = collate_fn([dataset[int(data_idx)]])
        panel.log_panel(step, split, i, **render_fn(batch))

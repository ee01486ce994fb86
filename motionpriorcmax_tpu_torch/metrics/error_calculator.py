"""Error calculators of the validation loops (JAX:
metrics/error_calculator.py, the reference's src/utils/metrics.py).

`make_error_calculator('DSEC' | 'MVSEC')` -> `OpticalFlowError`, whose
`run(predictions, batch)` gives EPE / 1PE / 2PE / 3PE / AE of
predictions['flow'] against the batch's GT flow over its valid pixels; the
MVSEC calculator scales both flows by the batch's 'time_scale'.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.flow_error import calculate_flow_error


class OpticalFlowError:
    """Flow errors of predictions {'flow': [B, 2, H, W]} against the batch's
    'forward_flow' (or 'gt_flow') over its 'flow_valid' pixels."""

    def __init__(self, time_scaled: bool = False):
        self.time_scaled = time_scaled

    def run(self, predictions: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        flow_gt = (batch["forward_flow"] if "forward_flow" in batch
                   else batch["gt_flow"])
        time_scale = batch.get("time_scale") if self.time_scaled else None
        return calculate_flow_error(flow_gt, predictions["flow"],
                                    event_mask=batch.get("flow_valid"),
                                    time_scale=time_scale)


def make_error_calculator(dataset: str) -> OpticalFlowError:
    """The calculator of `dataset`: 'DSEC', or 'MVSEC' (time-scaled)."""
    if dataset in ("DSEC", "MVSEC"):
        return OpticalFlowError(time_scaled=(dataset == "MVSEC"))
    raise ValueError(f"unknown dataset {dataset!r}")

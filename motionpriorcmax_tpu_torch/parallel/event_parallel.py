"""The focus loss with the event axis split over ranks (JAX:
parallel/event_parallel.py).

Each rank of an event group warps its event shard through the flow LUT,
which every rank computes from the same trajectories, and votes a partial
IWE through the vote kernels; the partials are summed over the group
(events are points, so the halo exchange of a pixel decomposition reduces
to that sum), and the blur, the objective and the smoothness term run on
the sum, the same on every rank.  The same up to float summation order as
the single-device loss.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..losses.focus import FocusLossConfig, focus_loss
from .distributed import shard_events


def focus_loss_event_sharded(
    cfg: FocusLossConfig,
    trajectories: torch.Tensor,
    times: torch.Tensor,
    events: torch.Tensor,
    mesh,
    num_pos_events: int = -1,
    cell_ends: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """`focus_loss` of the data rank's batch with its events split over the
    event axis of `mesh`.

    Args:
      trajectories: [B, T, N, 2], the same on every rank of the group.
      events: [B, M, 6], the data rank's events, M divisible by the
        event-axis size; positives first with polarity-aware batching,
        whose num_pos_events and M - num_pos_events must split evenly too.
      cell_ends: optional [B, S * cells] global LUT-cell boundaries of
        cell-sorted events; each rank clips them into its shard.

    Returns focus_loss's (loss, logs, misc) with the summed IWEs.
    """
    local, ends = shard_events(mesh, events, num_pos_events, cell_ends)
    return focus_loss(cfg, trajectories, times, local,
                      num_pos_events=num_pos_events, cell_ends=ends,
                      mesh=mesh)

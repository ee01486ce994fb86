"""Replicate padding to size multiples (JAX: ops/padding.py).

Pads H, W up to a multiple of min_size with edge (replicate) values,
RAFT-style, and crops back.
"""

from __future__ import annotations

from typing import Tuple

import torch


def padding_amounts(height: int, width: int, min_size: int = 8,
                    no_top_padding: bool = False
                    ) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) pads to reach multiples of min_size."""
    pad_ht = (-height) % min_size
    pad_wd = (-width) % min_size
    if no_top_padding:
        return 0, pad_ht, pad_wd // 2, pad_wd - pad_wd // 2
    return pad_ht // 2, pad_ht - pad_ht // 2, pad_wd // 2, pad_wd - pad_wd // 2


def requires_padding(height: int, width: int, min_size: int = 8) -> bool:
    return height % min_size != 0 or width % min_size != 0


def pad_to_multiple(x: torch.Tensor, min_size: int = 8,
                    no_top_padding: bool = False) -> torch.Tensor:
    """Replicate-pad the last two dims to multiples of min_size."""
    h, w = x.shape[-2:]
    top, bottom, left, right = padding_amounts(h, w, min_size, no_top_padding)
    if top == bottom == left == right == 0:
        return x
    rows = torch.arange(-top, h + bottom, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-left, w + right, device=x.device).clamp(0, w - 1)
    return x.index_select(-2, rows).index_select(-1, cols)


def unpad(x: torch.Tensor, orig_height: int, orig_width: int,
          min_size: int = 8, no_top_padding: bool = False) -> torch.Tensor:
    """Crop back to the original spatial size."""
    top, _, left, _ = padding_amounts(orig_height, orig_width, min_size,
                                      no_top_padding)
    return x[..., top:top + orig_height, left:left + orig_width]

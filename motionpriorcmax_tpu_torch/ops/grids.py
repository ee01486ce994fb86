"""Grid <-> trajectory-list packing and dense-flow upsampling
(JAX: ops/grids.py).

One trajectory per patch_size x patch_size tile, at the strided pixels
[s::n, s::n] with s = n // 2, row-major.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def tile_mask_positions(image_shape: Tuple[int, int], tile_size: int
                        ) -> np.ndarray:
    """[N, 2] int32 (y, x) pixel of each tile's trajectory, row-major."""
    h, w = image_shape
    s = tile_size // 2
    ys = np.arange(s, h, tile_size, dtype=np.int32)
    xs = np.arange(s, w, tile_size, dtype=np.int32)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([gy.reshape(-1), gx.reshape(-1)], axis=-1)


def coeffs_grid_to_list(coeff_grid: torch.Tensor, tile_size: int,
                        num_coeffs: int) -> torch.Tensor:
    """[B, S, 2K, H, W] coefficient grid -> [B, S, 2, N, K] per-tile
    coefficients, (y, x) dim order."""
    b, s, c2, _, _ = coeff_grid.shape
    if c2 != 2 * num_coeffs:
        raise ValueError(f"{c2} channels for {num_coeffs} coefficients")
    off = tile_size // 2
    sel = coeff_grid[:, :, :, off::tile_size, off::tile_size]
    n = sel.shape[-2] * sel.shape[-1]
    return sel.reshape(b, s, 2, num_coeffs, n).transpose(-1, -2)


def list_to_grid(feature_list: torch.Tensor, grid_shape: Tuple[int, int]
                 ) -> torch.Tensor:
    """[B, N, C] row-major over the (gh, gw) patch grid -> [B, C, gh, gw]."""
    b, n, c = feature_list.shape
    gh, gw = grid_shape
    if n != gh * gw:
        raise ValueError(f"{n} features for a {gh}x{gw} grid")
    return feature_list.reshape(b, gh, gw, c).permute(0, 3, 1, 2)


def _keys_cubic_weights(in_size: int, out_size: int, device
                        ) -> torch.Tensor:
    """[in, out] f32 resampling matrix of jax.image.resize(method='cubic')
    for upsampling: the Keys kernel (a = -0.5) at half-pixel centres,
    renormalized where taps fall outside the input (JAX's scale.py
    compute_weight_mat; torch's bicubic uses a = -0.75 and clamps)."""
    inv_scale = 1.0 / (out_size / in_size)
    sample = ((torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale
              - 0.5)
    x = (sample[None, :]
         - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = torch.where(x >= 2.0, torch.zeros_like(w), w)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def interpolate_dense_flow(patch_flow: torch.Tensor,
                           image_shape: Tuple[int, int]) -> torch.Tensor:
    """Bicubic upsample [B, C, gh, gw] -> [B, C, H, W], JAX's cubic resize."""
    gh, gw = patch_flow.shape[-2:]
    h, w = image_shape
    wy = _keys_cubic_weights(gh, h, patch_flow.device)
    wx = _keys_cubic_weights(gw, w, patch_flow.device)
    return torch.einsum("bchw,hH,wW->bcHW", patch_flow, wy, wx)


def dense_flow_from_traj(traj_flow: torch.Tensor, tile_size: int,
                         image_shape: Tuple[int, int]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, N, 2] per-tile displacement -> (dense [B, 2, H, W],
    patch [B, 2, H//n, W//n])."""
    h, w = image_shape
    patch_flow = list_to_grid(traj_flow, (h // tile_size, w // tile_size))
    return interpolate_dense_flow(patch_flow, image_shape), patch_flow

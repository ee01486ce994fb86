"""RAFTSpline: recurrent refinement of per-pixel curve parameters
(JAX: models/raft_spline/raft.py).

  * voxel slicing: corr grids at [0] + target_indices, context = the last
    nbins_context channels
  * context split tanh(net) / relu(inp)
  * lookup times = dt * target_index with dt = 1/(nbins_context-1); images
    are looked up at t=1
  * per iteration: flows -> coords1 = coords0 + flows -> corr lookup (the
    corr-window kernel) -> GRU update -> params += delta -> convex upsample
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ...device import no_tf32
from ..basis_mlp import BasisMLP
from .corr import build_corr_pyramid, compute_corr_volume, lookup_corr_pyramid
from .curves import (CURVE_TYPES, coords_grid, curve_basis_matrix,
                     curve_params_init, cvx_upsample)
from .extractor import BasicEncoder
from .update import BasicUpdateBlock

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class RAFTSplineConfig:
    """The JAX config's field names (the trajectory model YAML leaves).

    The JAX package's TPU layout knobs (remat_*, corr_lookup_impl) have no
    counterpart here: the port keeps the iterations' activations.
    """

    nbins_context: int = 41
    nbins_correlation: int = 25
    bezier_degree: int = 10
    curve_type: str = "BEZIER"          # BEZIER | POLYNOMIAL | LEARNED
    detach_bezier: bool = False
    use_events: bool = True
    use_boundary_images: bool = False
    ev_target_indices: Tuple[int, ...] = (8, 16, 24, 32, 40)
    ev_levels: Tuple[int, ...] = (1, 1, 1, 1, 4)
    img_levels: int = 4
    radius: int = 4
    hidden_dim: int = 128
    context_dim: int = 128
    context_norm: str = "batch"
    feature_dim: int = 256
    feature_norm: str = "instance"
    motion_dim: int = 128
    iters: int = 12
    # Train mode keeps the encoders' BatchNorm on its running statistics.
    freeze_bn: bool = False
    # Storage dtype of the correlation pyramid; the dot products are f32
    # and the lookup accumulates in f32 either way.
    corr_dtype: str = "float32"
    # Conv compute dtype of the encoders and the update block.  Only
    # 'float32' is ported (the forward runs with TF32 off, see no_tf32);
    # 'bfloat16' raises NotImplementedError.
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.curve_type not in CURVE_TYPES:
            raise ValueError(f"unknown curve_type {self.curve_type!r}; "
                             f"expected one of {CURVE_TYPES}")
        for name in ("corr_dtype", "compute_dtype"):
            if getattr(self, name) not in _DTYPES:
                raise ValueError(f"unknown {name} {getattr(self, name)!r}; "
                                 f"expected one of {tuple(_DTYPES)}")
        if self.compute_dtype != "float32":
            raise NotImplementedError(
                "compute_dtype='bfloat16' is not ported yet; use 'float32'")
        if not (self.use_events or self.use_boundary_images):
            raise ValueError("need use_events or use_boundary_images")
        if self.use_events:
            if 0 in self.ev_target_indices:
                raise ValueError("target index 0 is the reference grid")
            if not len(self.ev_target_indices) == len(self.ev_levels) > 0:
                raise ValueError("ev_target_indices and ev_levels differ in length")
            if max(self.ev_target_indices) >= self.nbins_context:
                raise ValueError("target index beyond nbins_context")
        if self.bezier_degree < 1:
            raise ValueError("bezier_degree must be >= 1")
        if self.iters < 1:
            raise ValueError("iters must be >= 1")

    @property
    def nbins_total(self) -> int:
        return self.nbins_context + self.nbins_correlation - 1

    @property
    def param_dim(self) -> int:
        return 2 * self.bezier_degree

    @property
    def levels(self) -> Tuple[int, ...]:
        """Pyramid depth per target: events first, then the image target."""
        ev = tuple(self.ev_levels) if self.use_events else ()
        img = (self.img_levels,) if self.use_boundary_images else ()
        return ev + img

    @property
    def corr_channels(self) -> int:
        # Level L holds the targets with levels >= L, so the lookup has
        # sum(levels) windows of (2r+1)^2 features.
        return sum(self.levels) * (2 * self.radius + 1) ** 2


class RAFTSpline(nn.Module):
    def __init__(self, cfg: RAFTSplineConfig):
        super().__init__()
        self.cfg = cfg
        context_in = 0
        if cfg.use_events:
            self.fnet_ev = BasicEncoder(cfg.nbins_correlation, cfg.feature_dim,
                                        cfg.feature_norm)
            context_in += cfg.nbins_context
        if cfg.use_boundary_images:
            self.fnet_img = BasicEncoder(3, cfg.feature_dim, cfg.feature_norm)
            context_in += 3
        self.cnet = BasicEncoder(context_in, cfg.hidden_dim + cfg.context_dim,
                                 cfg.context_norm)
        self.update_block = BasicUpdateBlock(cfg.corr_channels, cfg.param_dim,
                                             cfg.hidden_dim, cfg.context_dim,
                                             cfg.motion_dim)
        if cfg.curve_type == "LEARNED":
            self.basis_mlp = BasisMLP(cfg.bezier_degree, depth=2,
                                      activation="relu")

    def gen_voxel_grids(self, voxel_grid: torch.Tensor):
        """Corr grids at [0] + target indices, and the context grid."""
        cfg = self.cfg
        if voxel_grid.shape[1] != cfg.nbins_total:
            raise ValueError(f"voxel grid has {voxel_grid.shape[1]} bins, "
                             f"expected {cfg.nbins_total}")
        corr_grids = [voxel_grid[:, idx:idx + cfg.nbins_correlation]
                      for idx in (0, *cfg.ev_target_indices)]
        return corr_grids, voxel_grid[:, -cfg.nbins_context:]

    def train(self, mode: bool = True) -> "RAFTSpline":
        """With cfg.freeze_bn the encoders stay in eval mode: their BatchNorm
        keeps the running statistics (the JAX model's `train and not
        freeze_bn`)."""
        super().train(mode)
        if mode and self.cfg.freeze_bn:
            for name in ("fnet_ev", "fnet_img", "cnet"):
                if hasattr(self, name):
                    getattr(self, name).eval()
        return self

    def forward(self, voxel_grid: Optional[torch.Tensor] = None,
                images: Optional[Sequence[torch.Tensor]] = None,
                iters: Optional[int] = None, test_mode: bool = False,
                return_sequences: bool = False):
        """The refinement loop over `iters` (cfg.iters when None) iterations.

        Returns, as the JAX model does:
          test_mode: (params [B, 2*deg, h/8, w/8], params_up [B, 2*deg, h, w])
            of the last iteration;
          return_sequences: (params_seq [iters, B, 2*deg, h/8, w/8],
            mask_seq [iters, B, 576, h/8, w/8]), low resolution;
          otherwise: the list of the iters upsampled predictions.
        BatchNorm follows the module's mode (train(): batch statistics and
        running updates, unless cfg.freeze_bn).  Differentiable, the corr
        lookup included (its backward is the corr-window backward kernel);
        the caller runs the backward under `no_tf32` too.
        """
        iters = self.cfg.iters if iters is None else iters
        if iters < 1:
            raise ValueError("iters must be >= 1")
        keep_all = not test_mode
        with no_tf32():             # compute_dtype 'float32', the one ported
            params_seq, mask_seq = self._refine(voxel_grid, images, iters,
                                                keep_all)
            if test_mode:
                return params_seq[-1], cvx_upsample(params_seq[-1],
                                                    mask_seq[-1])
            if return_sequences:
                return torch.stack(params_seq), torch.stack(mask_seq)
            return [cvx_upsample(p, m) for p, m in zip(params_seq, mask_seq)]

    def _refine(self, voxel_grid, images, iters: int, keep_all: bool
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Encoders, pyramid and the update loop; returns the per-iteration
        params and upsample masks (the last iteration's only unless
        keep_all)."""
        cfg = self.cfg
        lookup_ts: List[float] = []
        corr_volumes = []
        context_input = None

        if cfg.use_events:
            if voxel_grid is None:
                raise ValueError("use_events needs voxel_grid")
            corr_grids, context_input = self.gen_voxel_grids(voxel_grid)
            fmaps = self.fnet_ev(corr_grids)
            corr_volumes.append(compute_corr_volume(fmaps[0],
                                                    torch.stack(fmaps[1:])))
            dt = 1.0 / (cfg.nbins_context - 1)
            lookup_ts.extend(dt * i for i in cfg.ev_target_indices)

        if cfg.use_boundary_images:
            if images is None or len(images) != 2:
                raise ValueError("use_boundary_images needs an image pair")
            imgs = [2.0 * (im.float() / 255.0) - 1.0 for im in images]
            fm = self.fnet_img(imgs)
            corr_volumes.append(compute_corr_volume(fm[0], fm[1][None]))
            lookup_ts.append(1.0)
            context_input = (imgs[0] if context_input is None
                             else torch.cat([context_input, imgs[0]], dim=1))

        corr = torch.cat(corr_volumes, dim=0).to(_DTYPES[cfg.corr_dtype])
        pyramid = build_corr_pyramid(corr, cfg.levels)
        del corr, corr_volumes

        cnet = self.cnet(context_input)
        net = torch.tanh(cnet[:, :cfg.hidden_dim])
        inp = torch.relu(cnet[:, cfg.hidden_dim:])

        b, _, h, w = context_input.shape
        dev = context_input.device
        coords0 = coords_grid(b, h // 8, w // 8, device=dev)
        params = curve_params_init(b, cfg.bezier_degree, h, w, 8, device=dev)

        ts = torch.tensor(lookup_ts, dtype=torch.float32, device=dev)
        basis_mat = curve_basis_matrix(
            ts, cfg.bezier_degree, cfg.curve_type,
            self.basis_mlp if cfg.curve_type == "LEARNED" else None)  # [T, P]

        params_seq: List[torch.Tensor] = []
        mask_seq: List[torch.Tensor] = []
        for _ in range(iters):
            if cfg.detach_bezier:
                params = params.detach()
            pv = params.reshape(b, 2, cfg.bezier_degree, *params.shape[2:])
            flows = torch.einsum("bdphw,tp->tbdhw", pv, basis_mat)
            coords1 = coords0[None] + flows
            corr_total = lookup_corr_pyramid(pyramid, coords1, cfg.radius)
            net, up_mask, delta = self.update_block(net, inp, corr_total,
                                                    params)
            params = params + delta
            if not keep_all:
                params_seq.clear()
                mask_seq.clear()
            params_seq.append(params)
            mask_seq.append(up_mask)
        return params_seq, mask_seq

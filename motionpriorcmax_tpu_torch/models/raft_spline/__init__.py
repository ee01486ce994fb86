"""RAFT-Spline trajectory network (JAX: models/raft_spline/)."""

from .corr import (bilinear_sample_hw, build_corr_pyramid, compute_corr_volume,
                   lookup_corr_pyramid)
from .curves import (coords_grid, curve_basis_matrix, curve_flow_from_reference,
                     curve_params_init, cvx_upsample)
from .raft import RAFTSpline, RAFTSplineConfig

__all__ = [
    "RAFTSpline", "RAFTSplineConfig", "bilinear_sample_hw",
    "build_corr_pyramid", "compute_corr_volume", "coords_grid",
    "curve_basis_matrix", "curve_flow_from_reference", "curve_params_init",
    "cvx_upsample", "lookup_corr_pyramid",
]

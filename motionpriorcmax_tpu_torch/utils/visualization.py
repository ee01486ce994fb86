"""Flow and IWE colorization for the image panels (JAX:
utils/visualization.py; the port's own copy).

Pure NumPy, no cv2: the HSV -> RGB conversion follows OpenCV's uint8 HSV
convention (H in [0, 180), S and V in [0, 255]) that the reference's
panels use, with its truncating uint8 casts.
"""

from __future__ import annotations

import numpy as np


def _hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """OpenCV-convention uint8 HSV -> RGB."""
    h = hsv[..., 0].astype(np.float32) * 2.0  # degrees
    s = hsv[..., 1].astype(np.float32) / 255.0
    v = hsv[..., 2].astype(np.float32) / 255.0
    c = v * s
    hp = h / 60.0
    x = c * (1 - np.abs(np.mod(hp, 2) - 1))
    z = np.zeros_like(c)
    idx = np.floor(hp).astype(int) % 6
    r = np.select([idx == 0, idx == 1, idx == 2, idx == 3, idx == 4, idx == 5],
                  [c, x, z, z, x, c])
    g = np.select([idx == 0, idx == 1, idx == 2, idx == 3, idx == 4, idx == 5],
                  [x, c, c, x, z, z])
    b = np.select([idx == 0, idx == 1, idx == 2, idx == 3, idx == 4, idx == 5],
                  [z, z, x, c, c, x])
    m = v - c
    rgb = np.stack([r + m, g + m, b + m], axis=-1)
    return (rgb * 255.0).astype(np.uint8)


def flow_to_rgb(flow: np.ndarray, max_magnitude: float | None = None,
                ord: float = 1.0) -> np.ndarray:
    """HSV colorization of a [2, H, W] (y, x) flow field -> [H, W, 3] uint8.

    Reference: color_optical_flow (src/utils/visualization.py:14-55):
    hue = (atan2(x, y) + pi) / 2 in degrees, value = magnitude**ord scaled.
    """
    flow_y, flow_x = np.asarray(flow[0]), np.asarray(flow[1])
    flows = np.stack((flow_y, flow_x), axis=2)
    flows[~np.isfinite(flows)] = 0
    mag = np.linalg.norm(flows, axis=2) ** ord
    ang = (np.arctan2(flow_x, flow_y) + np.pi) * 180.0 / np.pi / 2.0
    hsv = np.zeros(flow_y.shape + (3,), dtype=np.uint8)
    hsv[..., 0] = ang.astype(np.uint8)
    hsv[..., 1] = 255
    if max_magnitude is None:
        max_magnitude = mag.max()
    hsv[..., 2] = (255 * mag / (max_magnitude + 1e-6)).astype(np.uint8)
    return _hsv_to_rgb_u8(hsv)


def color_wheel(size: int = 256) -> np.ndarray:
    """HSV color wheel legend for flow maps (reference :44-55).

    Returns [size, size, 3] uint8.
    """
    xx, yy = np.meshgrid(np.linspace(-1, 1, size), np.linspace(-1, 1, size))
    mag = np.linalg.norm(np.stack((xx, yy), axis=2), axis=2)
    ang = (np.arctan2(xx, yy) + np.pi) * 180.0 / np.pi / 2.0
    hsv = np.zeros((size, size, 3), dtype=np.uint8)
    hsv[..., 0] = ang.astype(np.uint8)
    hsv[..., 1] = 255
    hsv[..., 2] = (255 * mag / mag.max()).astype(np.uint8)
    return _hsv_to_rgb_u8(hsv)


def normalize_iwe(images: np.ndarray, invert: bool = False) -> np.ndarray:
    """Min-max normalize a stack of images to uint8 (reference :57-63)."""
    images = np.asarray(images, dtype=np.float32)
    mn = images.min(axis=(-2, -1), keepdims=True)
    mx = images.max(axis=(-2, -1), keepdims=True)
    out = 255 * (images - mn) / (mx - mn + 1e-6)
    if invert:
        out = 255 - out
    return out.astype(np.uint8)

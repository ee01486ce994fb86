"""Host-side train-time augmentation for MultiFlow samples
(JAX: data/augment.py; the port's own copy).

Plain numpy on the host, consuming the layouts MultiflowDatasubset
produces:

  voxel  [C, H, W]
  flows  list of [2, H, W], channel 0 = x
  images list of [3, H, W]
  events [N, 5] rows (y, x, t_norm, p, bin) or None

Crops use a fixed output size so the batch shapes stay fixed; only the
window position is random.  Each augmentor draws from its own
numpy Generator (`seed`), the same draws as the JAX package's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


class SpatialAugmentor:
    """Random horizontal/vertical flip + random fixed-size crop.

    Flips mirror all spatial tensors and negate the matching flow component
    (x for horizontal, y for vertical); event coordinates are mirrored with
    the same convention.  Cropping selects one window shared by every tensor;
    events are shifted into window coordinates and rows falling outside are
    dropped (flow *values* are displacements — unchanged by cropping).
    """

    def __init__(self, h_flip_prob: float = 0.5, v_flip_prob: float = 0.0,
                 crop_hw: Optional[Tuple[int, int]] = None, seed: int = 0):
        self.h_flip_prob = h_flip_prob
        self.v_flip_prob = v_flip_prob
        self.crop_hw = crop_hw
        self.rng = np.random.default_rng(seed)

    def __call__(self, voxel: Optional[np.ndarray],
                 flows: Sequence[np.ndarray],
                 images: Sequence[np.ndarray],
                 events: Optional[np.ndarray]):
        flows = [np.asarray(f) for f in flows]
        images = [np.asarray(im) for im in images]
        h, w = flows[0].shape[-2:]
        if events is not None:
            events = np.array(events, copy=True)

        if self.rng.random() < self.h_flip_prob:
            voxel = voxel[..., ::-1] if voxel is not None else None
            flows = [np.stack([-f[0, :, ::-1], f[1, :, ::-1]]) for f in flows]
            images = [im[..., ::-1] for im in images]
            if events is not None:
                events[:, 1] = (w - 1) - events[:, 1]

        if self.rng.random() < self.v_flip_prob:
            voxel = voxel[..., ::-1, :] if voxel is not None else None
            flows = [np.stack([f[0, ::-1], -f[1, ::-1]]) for f in flows]
            images = [im[..., ::-1, :] for im in images]
            if events is not None:
                events[:, 0] = (h - 1) - events[:, 0]

        if self.crop_hw is not None:
            ch, cw = self.crop_hw
            if ch > h or cw > w:
                raise ValueError(f"crop {self.crop_hw} larger than {(h, w)}")
            y0 = int(self.rng.integers(0, h - ch + 1))
            x0 = int(self.rng.integers(0, w - cw + 1))
            sl = np.s_[..., y0:y0 + ch, x0:x0 + cw]
            voxel = voxel[sl] if voxel is not None else None
            flows = [f[sl] for f in flows]
            images = [im[sl] for im in images]
            if events is not None:
                events[:, 0] -= y0
                events[:, 1] -= x0
                keep = ((events[:, 0] >= 0) & (events[:, 0] < ch)
                        & (events[:, 1] >= 0) & (events[:, 1] < cw))
                events = events[keep]

        voxel = np.ascontiguousarray(voxel) if voxel is not None else None
        flows = [np.ascontiguousarray(f) for f in flows]
        images = [np.ascontiguousarray(im) for im in images]
        return voxel, flows, images, events


class PhotometricAugmentor:
    """Brightness / contrast / gamma jitter on [3, H, W] float images in
    [0, 255].  Never touches events or voxels — photometric noise has no
    event-camera analog (events are brightness-*change* driven)."""

    def __init__(self, brightness: float = 0.2, contrast: float = 0.2,
                 gamma: float = 0.2, seed: int = 0):
        self.brightness = brightness
        self.contrast = contrast
        self.gamma = gamma
        self.rng = np.random.default_rng(seed)

    def __call__(self, images: Sequence[np.ndarray]) -> List[np.ndarray]:
        out = []
        # One draw shared by both boundary images: they depict the same scene
        # and the model compares them — decorrelated jitter would inject a
        # fake global brightness change.
        db = self.rng.uniform(-self.brightness, self.brightness) * 255.0
        dc = 1.0 + self.rng.uniform(-self.contrast, self.contrast)
        dg = 1.0 + self.rng.uniform(-self.gamma, self.gamma)
        for im in images:
            x = np.asarray(im, np.float32)
            mean = x.mean()
            x = (x - mean) * dc + mean + db
            x = 255.0 * np.power(np.clip(x / 255.0, 0.0, 1.0), dg)
            out.append(np.clip(x, 0.0, 255.0).astype(np.float32))
        return out


class MultiflowAugmentor:
    """Composite matching MultiflowDatasubset's single-callable hook
    (data/multiflow.py): spatial on everything, photometric on images."""

    def __init__(self, spatial: Optional[SpatialAugmentor] = None,
                 photometric: Optional[PhotometricAugmentor] = None):
        self.spatial = spatial
        self.photometric = photometric

    def __call__(self, voxel, flows, images, events):
        if self.spatial is not None:
            voxel, flows, images, events = self.spatial(
                voxel, flows, images, events)
        if self.photometric is not None:
            images = self.photometric(images)
        return voxel, flows, images, events

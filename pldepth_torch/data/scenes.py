"""Structured synthetic scenes (``pldepth_tpu/data/scenes.py``):
piecewise-smooth depth with true occlusion boundaries and textured images.

A tilted smooth background plane with N opaque objects (rotated ellipses /
rectangles) composited by inverse depth (per-pixel max), each region with
its own albedo and mild texture, so image edges sit on the depth
discontinuities that the edge metrics and active learning key on. ``gt``
is inverse depth in (0.05, 1.0], higher = closer.

Every sample is a pure function of (seed, index) through the JAX package's
numpy ``Generator`` calls, in the same order. The band-limited fields are
upsampled by :func:`_resize_bilinear`, which keeps the JAX package's rule
(``pldepth_tpu/data/io.py:resize_bilinear``): cv2 ``INTER_LINEAR`` when
cv2 imports, else TF's half-pixel grid. With cv2 present the scenes equal
the JAX package's bit for bit. ``data/io.py:resize_bilinear`` stays on the
TF grid (its rule is held by tests/test_torch_resize.py).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from pldepth_torch.data import io as dio
from pldepth_torch.data.datasets import DepthDataset


def _resize_bilinear(arr: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """(h, w) f32 -> ``hw``: cv2 ``INTER_LINEAR`` when it imports (the JAX
    package's host resize), else the port's TF-grid resize."""
    try:
        import cv2
    except ImportError:
        return dio.resize_bilinear(arr, hw)
    return cv2.resize(arr, (int(hw[1]), int(hw[0])),
                      interpolation=cv2.INTER_LINEAR).astype(np.float32)


def _coords(h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    yy, xx = np.meshgrid(np.linspace(-1.0, 1.0, h, dtype=np.float32),
                         np.linspace(-1.0, 1.0, w, dtype=np.float32), indexing="ij")
    return yy, xx


def _low_freq(rng: np.random.Generator, hw: Tuple[int, int], cells: int = 6,
              amp: float = 1.0) -> np.ndarray:
    """Band-limited noise in [-amp, amp] (bilinear upsample of a coarse grid)."""
    coarse = rng.normal(size=(cells, cells)).astype(np.float32)
    field = _resize_bilinear(coarse, hw)
    m = max(float(np.abs(field).max()), 1e-6)
    return field * (amp / m)


def _object_sdf(rng: np.random.Generator, yy: np.ndarray, xx: np.ndarray):
    """Inside-mask of one random rotated ellipse or rectangle."""
    cy, cx = rng.uniform(-0.75, 0.75, size=2)
    ry = rng.uniform(0.12, 0.45)
    rx = rng.uniform(0.12, 0.45)
    theta = rng.uniform(0.0, np.pi)
    ct, st = np.cos(theta), np.sin(theta)
    u = (yy - cy) * ct - (xx - cx) * st
    v = (yy - cy) * st + (xx - cx) * ct
    if rng.uniform() < 0.5:  # ellipse
        return (u / ry) ** 2 + (v / rx) ** 2 <= 1.0
    return (np.abs(u) <= ry) & (np.abs(v) <= rx)  # rectangle


def generate_scene(index: int, image_size: int = 224, seed: int = 0,
                   n_objects_range: Tuple[int, int] = (3, 8),
                   mask_frac: float = 0.97) -> Dict[str, np.ndarray]:
    """One deterministic scene: {"image", "gt", "mask"} plus the integer
    region-id map under "segments" (background = 0)."""
    h = w = image_size
    rng = np.random.default_rng((seed * 1_000_003 + index) * 2 + 1)
    yy, xx = _coords(h, w)

    # background: far tilted plane + gentle relief, inverse depth 0.05-0.35
    gy, gx = rng.uniform(-0.08, 0.08, size=2)
    gt = 0.18 + gy * yy + gx * xx + _low_freq(rng, (h, w), cells=5, amp=0.06)
    gt = np.clip(gt, 0.05, 0.35).astype(np.float32)
    segments = np.zeros((h, w), np.int32)

    # objects in strictly increasing closeness bands: every overlap is an
    # occlusion with a depth jump; each surface a tilted plane + mild relief
    n_obj = int(rng.integers(n_objects_range[0], n_objects_range[1] + 1))
    bands = np.linspace(0.42, 0.95, n_obj)
    for k in range(n_obj):
        inside = _object_sdf(rng, yy, xx)
        oy, ox = rng.uniform(-0.05, 0.05, size=2)
        depth_k = bands[k] + oy * yy + ox * xx + _low_freq(rng, (h, w), cells=4, amp=0.02)
        depth_k = np.clip(depth_k, 0.36, 1.0).astype(np.float32)
        closer = inside & (depth_k > gt)
        gt = np.where(closer, depth_k, gt)
        segments = np.where(closer, np.int32(k + 1), segments)

    # image: per-region albedo + low-frequency texture + depth shading
    albedos = rng.permutation(np.linspace(0.15, 0.9, n_obj + 1)).astype(np.float32)
    base = albedos[segments]
    texture = _low_freq(rng, (h, w), cells=12, amp=0.05)
    shade = 0.15 * (gt - gt.mean())
    lum = np.clip(base + texture + shade, 0.02, 1.0)
    tint = rng.uniform(0.85, 1.15, size=3).astype(np.float32)
    image = np.clip(lum[..., None] * tint[None, None, :], 0.0, 1.0).astype(np.float32)

    mask = (rng.uniform(size=(h, w)) < mask_frac).astype(np.float32)
    mask[0, 0] = 1.0
    return {"image": image, "gt": gt, "mask": mask, "segments": segments}


def true_boundary_map(gt: np.ndarray, jump: float = 0.04) -> np.ndarray:
    """Pixels whose 4-neighbourhood inverse-depth jump exceeds ``jump``."""
    b = np.zeros_like(gt, dtype=bool)
    dy = np.abs(np.diff(gt, axis=0)) > jump
    dx = np.abs(np.diff(gt, axis=1)) > jump
    b[:-1, :] |= dy
    b[1:, :] |= dy
    b[:, :-1] |= dx
    b[:, 1:] |= dx
    return b


def boundary_distance(gt: np.ndarray, jump: float = 0.04) -> np.ndarray:
    """Distance (pixels) from each pixel to the nearest true boundary: cv2's
    ``distanceTransform`` (L2, 5x5 mask) when cv2 imports, else scipy's
    exact Euclidean transform, as in the JAX package."""
    b = true_boundary_map(gt, jump)
    if not b.any():
        return np.full(gt.shape, np.inf, np.float32)
    try:
        import cv2
    except ImportError:
        from scipy.ndimage import distance_transform_edt

        return distance_transform_edt(~b).astype(np.float32)
    # distanceTransform measures to the nearest zero pixel
    return cv2.distanceTransform((~b).astype(np.uint8), cv2.DIST_L2, 5).astype(np.float32)


def SceneDepthDataset(n: int = 64, image_size: int = 224, seed: int = 0,
                      mask_frac: float = 0.97) -> DepthDataset:
    """Registry dataset ``scenes``: samples are {"image", "gt", "mask"}."""

    def load(i: int) -> Dict[str, np.ndarray]:
        s = generate_scene(i, image_size, seed, mask_frac=mask_frac)
        return {"image": s["image"], "gt": s["gt"], "mask": s["mask"]}

    return DepthDataset(name="scenes", size=n, loader=load)

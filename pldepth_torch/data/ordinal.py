"""Eval-time ordinal pair / ranking generation with disk caching
(``pldepth_tpu/data/ordinal.py``).

A copy of the JAX package's seeded host numpy, bit-equal. The reference's
generic providers (pldepth/data/providers/generic_ranking_provider.py:12-223),
for the zero-shot cross-dataset evaluation: per image, seeded random pixel
pairs ``(point0, point1, relation, z0, z1)`` or K-lists ``(K, 2)``, with
``invert_relation_sign`` for ascending-depth datasets (lower = closer:
NYUDv2/Ibims/Sintel/DIODE, reference pl_hourglass.py:22-31) and an npy cache
under a cache directory (reference CACHE_PATH_PREFIX,
generic_ranking_provider.py:36,66-78). Generation is vectorized; for
ascending data the ranking labels become 1/(z+1), sorted by that label (the
reference's order).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np

from pldepth_torch.data.datasets import DepthDataset
from pldepth_torch.eval.metrics import ratio_relation as _relation

log = logging.getLogger(__name__)


def _check_flat_index_range(h: int, w: int) -> None:
    """Flat pixel indices ride in float32 arrays (the reference layout);
    float32 is integer-exact only to 2^24 — same guard as the training
    samplers (sampling/samplers.py)."""
    if h * w > 1 << 24:
        raise ValueError(
            f"gt resolution {h}x{w} = {h * w} pixels exceeds the "
            f"float32-exact flat-index range (2^24 = {1 << 24})"
        )


def generate_ordinal_pairs(
    ds: DepthDataset,
    pairs_per_image: int,
    seed: int,
    threshold: float = 0.03,
    invert_relation_sign: Optional[bool] = None,
) -> np.ndarray:
    """(N, P, 5) float32 [point0, point1, relation, z0, z1] per image."""
    if invert_relation_sign is None:
        invert_relation_sign = ds.asc_depth_order
    rng = np.random.default_rng(seed)
    out = np.zeros((len(ds), pairs_per_image, 5), np.float32)
    for i in range(len(ds)):
        gt = np.squeeze(ds[i]["gt"])
        h, w = gt.shape
        _check_flat_index_range(h, w)
        p0 = rng.integers(0, h * w, pairs_per_image)
        p1 = rng.integers(0, h * w, pairs_per_image)
        z0, z1 = gt.reshape(-1)[p0], gt.reshape(-1)[p1]
        rel = _relation(z0, z1, threshold)
        if invert_relation_sign:
            rel = -rel
        out[i] = np.stack([p0, p1, rel, z0, z1], axis=-1)
    return out


def generate_eval_rankings(
    ds: DepthDataset,
    rankings_per_image: int,
    ranking_size: int,
    seed: int,
    invert_relation_sign: Optional[bool] = None,
) -> np.ndarray:
    """(N, RPI, K, 2) float32 [flat_idx, label] per image, label-descending.

    For ascending-depth datasets labels become 1/(z+1) so that larger label
    still means closer (generic_ranking_provider.py:201-212).
    """
    if invert_relation_sign is None:
        invert_relation_sign = ds.asc_depth_order
    rng = np.random.default_rng(seed)
    out = np.zeros((len(ds), rankings_per_image, ranking_size, 2), np.float32)
    for i in range(len(ds)):
        gt2d = np.squeeze(ds[i]["gt"])
        _check_flat_index_range(*gt2d.shape)
        gt = gt2d.reshape(-1)
        idx = rng.integers(0, gt.size, (rankings_per_image, ranking_size))
        z = gt[idx]
        labels = 1.0 / (z + 1.0) if invert_relation_sign else z
        order = np.argsort(-labels, axis=-1)
        out[i, :, :, 0] = np.take_along_axis(idx.astype(np.float32), order, axis=-1)
        out[i, :, :, 1] = np.take_along_axis(labels, order, axis=-1)
    return out


def cached(
    generate_fn, cache_dir: str, cache_key: str, *args, use_cache: bool = True, **kw
) -> np.ndarray:
    """npy caching wrapper (reference retrieve_* path, :66-78,169-178)."""
    if not use_cache or not cache_dir:
        return generate_fn(*args, **kw)
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, cache_key + ".npy")
    if os.path.exists(path):
        log.info("ordinal cache hit: %s", path)
        return np.load(path)
    data = generate_fn(*args, **kw)
    np.save(path, data)
    return data


def pair_agreement_error(pred_flat: np.ndarray, pairs: np.ndarray, threshold: float = 0.03) -> float:
    """WHDR of one image's predictions against cached ordinal pairs.

    pred scores are descending-depth by model convention; relation of the
    prediction uses the same tau ratio test.
    """
    p0 = pairs[:, 0].astype(int)
    p1 = pairs[:, 1].astype(int)
    rel_gt = pairs[:, 2]
    rel_pred = _relation(pred_flat[p0], pred_flat[p1], threshold)
    return float(np.mean(rel_gt != rel_pred))

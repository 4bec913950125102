"""Evaluation metrics on the host (``pldepth_tpu/eval/metrics.py``):
ordinal error / WHDR, NDCG@k, depth-edge metrics.

A copy of the JAX package's host numpy, reference-exact: the same seeds,
the same ``np.random.RandomState`` streams and the same quirks, so a
prediction scores the same number in either package. cv2 is imported by
the edge functions only; without it they raise ``RuntimeError``, which the
Evaluator reads as "no edge keys".
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("cv2 unavailable: edge metrics require OpenCV") from e
    return cv2


def _minmax(x: np.ndarray, lo: float, hi: float) -> np.ndarray:
    xmin, xmax = float(x.min()), float(x.max())
    if xmax - xmin < 1e-12:
        return np.zeros_like(x) + lo
    return (x - xmin) * (hi - lo) / (xmax - xmin) + lo


def ordinal_error(pred: np.ndarray, gt: np.ndarray, num_pairs: int = 5000, seed: int = 10,
                  invert_pred_order: bool = False) -> float:
    """1 - pairwise order agreement over random pixel pairs.

    Reference definition (metrics.py:60-70): 5000 pairs drawn without
    replacement from the flattened maps with np.random.seed(10), tau=0.
    ``invert_pred_order`` handles ascending-depth ground truths
    (pl_hourglass.py:22-31): the model predicts descending (closer=larger)
    scores, so comparisons flip against ascending-depth datasets.
    """
    pred = np.squeeze(np.asarray(pred)).reshape(-1)
    gt = np.squeeze(np.asarray(gt)).reshape(-1)
    assert pred.shape == gt.shape, (pred.shape, gt.shape)
    num_pairs = min(num_pairs, pred.size // 2)  # small-image guard
    rs = np.random.RandomState(seed)
    idx = rs.choice(pred.size, num_pairs * 2, replace=False)
    i0, i1 = np.split(idx, 2)
    pred_order = pred[i0] > pred[i1]
    if invert_pred_order:
        pred_order = ~pred_order
    gt_order = gt[i0] > gt[i1]
    return 1.0 - float(np.equal(pred_order, gt_order).sum()) / num_pairs


def ratio_relation(a, b, tau: float):
    """The reference ordinal relation (depth_utils.py:5-21): sign of the
    (1+tau)-banded ratio test, 0 inside the tie band."""
    eps = 1e-10
    ratio = (np.asarray(a) + eps) / (np.asarray(b) + eps)
    return np.where(ratio >= 1 + tau, 1.0, np.where(ratio <= 1.0 / (1 + tau), -1.0, 0.0))


def whdr(pred: np.ndarray, gt: np.ndarray, tau: float = 0.03, num_pairs: int = 5000,
         seed: int = 10, invert_pred_order: bool = False) -> float:
    """Weighted Human Disagreement Rate with the tau ratio test, in float64.

    Pairs whose gt ratio lies in [1/(1+tau), 1+tau] demand relation 0,
    which predictions (continuous) satisfy only under the same test on
    predicted values.
    """
    pred = np.squeeze(np.asarray(pred)).reshape(-1).astype(np.float64)
    gt = np.squeeze(np.asarray(gt)).reshape(-1).astype(np.float64)
    num_pairs = min(num_pairs, pred.size // 2)  # small-image guard
    rs = np.random.RandomState(seed)
    idx = rs.choice(pred.size, num_pairs * 2, replace=False)
    i0, i1 = np.split(idx, 2)
    r_gt = ratio_relation(gt[i0], gt[i1], tau)
    r_pred = ratio_relation(pred[i0], pred[i1], tau)
    if invert_pred_order:
        r_pred = -r_pred
    return float(np.mean(r_gt != r_pred))


def _dcg(rel: np.ndarray) -> float:
    # reference calcDCG (metrics.py:83-89)
    return float((rel / np.log2(np.arange(rel.size) + 2)).sum())


def ndcg_at_k(pred: np.ndarray, gt: np.ndarray, list_size: int = 200, seed: int = 69) -> float:
    """NDCG@list_size over sampled pixels with relevance 1/(depth+1).

    Reference calc_d (metrics.py:92-109): pred minmax-normalized to [0,1],
    both pred and gt values at `list_size` seeded random pixels are sorted
    ascending, relevance 1/(d+1), ndcg = dcg(pred)/dcg(gt).

    NOTE (faithful quirk): because *both* lists are sorted by their own
    values, this measures similarity of the sorted value distributions, not
    ranking agreement -- it can exceed 1 and is insensitive to pixel
    correspondence. Kept exactly as defined for score parity.
    """
    pred = np.squeeze(np.asarray(pred))
    gt = np.squeeze(np.asarray(gt))
    pred = _minmax(pred.astype(np.float64), 0.0, 1.0)
    list_size = min(list_size, pred.size)  # small-image guard
    rs = np.random.RandomState(seed)
    ids = rs.choice(pred.size, size=list_size, replace=False)
    sorted_pred = np.sort(pred.reshape(-1)[ids])
    sorted_gt = np.sort(gt.reshape(-1)[ids])
    return _dcg(1.0 / (sorted_pred + 1.0)) / _dcg(1.0 / (sorted_gt + 1.0))


def auto_canny_thresholds(image_u8: np.ndarray, sigma: float = 1.8) -> Tuple[int, int]:
    """Median-based Canny thresholds (reference preprocess_utils.py:4-13)."""
    v = float(np.median(image_u8))
    lower = int(max(0, (1.0 - sigma) * v))
    upper = int(min(255, (1.0 + sigma) * v))
    return lower, upper


def auto_canny(image_u8: np.ndarray, sigma: float = 1.8) -> np.ndarray:
    cv2 = _cv2()
    lo, hi = auto_canny_thresholds(image_u8, sigma)
    return cv2.Canny(image_u8, lo, hi)


def depth_edge_metric(pred: np.ndarray, gt: np.ndarray) -> Tuple[float, float]:
    """(depth boundary error, completeness error).

    Reference depth_edge_metric (metrics.py:123-144): minmax to uint8, Canny
    both maps, L2 distance transforms clamped at >10 -> 0, cross-weighted
    sums normalized by edge mass.

    NOTE (faithful quirk): the reference feeds the *edge map itself* to
    cv2.distanceTransform (distance to the nearest zero/non-edge pixel)
    rather than its inverse: perfectly aligned 1-px edges score ~1, fully
    displaced edges ~0. Kept as defined for score parity.
    """
    cv2 = _cv2()
    pred_u8 = _minmax(np.squeeze(np.asarray(pred)), 0, 255).astype(np.uint8)
    gt_u8 = _minmax(np.squeeze(np.asarray(gt)), 0, 255).astype(np.uint8)
    y = auto_canny(pred_u8)
    y_star = auto_canny(gt_u8)

    e = cv2.distanceTransform(y, cv2.DIST_L2, 3)
    e[e > 10] = 0
    e_star = cv2.distanceTransform(y_star, cv2.DIST_L2, 3)
    e_star[e_star > 10] = 0

    with np.errstate(divide="ignore", invalid="ignore"):
        boundary = float(np.divide((e_star * y).sum(), y.sum()))
        completeness = float(np.divide((e * y_star).sum(), y_star.sum()))
    return boundary, completeness

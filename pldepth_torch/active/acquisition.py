"""Edge-disagreement acquisition for active learning
(``pldepth_tpu/active/acquisition.py``).

Rebuild of the reference acquisition pipeline
(pldepth/active_learning/active_learning_method.py:22-119 +
preprocess_utils.py): compare Canny edges of the input image against Canny
edges of the (unsharp-masked) predicted depth map; where they disagree most
(per-tile Hausdorff distance), query the oracle.

``tile_hausdorff`` and the edge maps are copies of the JAX package's host
numpy and cv2 calls. ``tile_hausdorff_batch`` takes the place of the JAX
package's jitted XLA function: the same masked (T, t^2, t^2) min / max
reductions over a precomputed within-tile distance matrix, in plain torch on
the device that holds the edge maps, with the same values and witnesses as
the numpy path (ties go to the first index in numpy, XLA and torch alike).
There is no Pallas kernel behind it in the JAX package, so it has no
hand-written kernel here. cv2 is imported inside the functions that use it.
"""

from __future__ import annotations

import logging
import math
from typing import Tuple

import numpy as np
import torch

from pldepth_torch.core.device import DeviceLike, resolve_device
from pldepth_torch.eval.metrics import _minmax, auto_canny

log = logging.getLogger(__name__)

# bound on the masked (chunk, T, t^2, t^2) f32 transient of one reduction in
# tile_hausdorff_batch: at 448^2 / split 32 an image needs 157 MB of it
HAUSDORFF_CHUNK_BYTES = 1 << 30


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("active learning acquisition requires OpenCV") from e
    return cv2


def _tileize(edges: np.ndarray, split: int) -> np.ndarray:
    """(H, W) -> (split*split, th, tw) row-major tiles (reference splitImage,
    preprocess_utils.py:29-42; generalized to non-square images -- the
    reference reshape assumed H == W and crashed/cropped otherwise)."""
    h, w = edges.shape
    th, tw = h // split, w // split
    tiles = edges[: th * split, : tw * split].reshape(split, th, split, tw)
    return tiles.transpose(0, 2, 1, 3).reshape(split * split, th, tw)


def _tile_distances(th: int, tw: int) -> np.ndarray:
    """(t^2, t^2) f32 distances between the cells of a th x tw tile."""
    rr, cc = np.divmod(np.arange(th * tw), tw)
    return np.hypot(rr[:, None] - rr[None, :], cc[:, None] - cc[None, :]).astype(np.float32)


def tile_hausdorff(
    in_edges: np.ndarray, pred_edges: np.ndarray, split: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-tile symmetric Hausdorff distance + input-edge witness point.

    Returns (dist (T,), points (T, 2) absolute row/col), with the reference's
    fallbacks: both-empty tiles get the tile-diagonal distance and a
    center/random-edge point (active_learning_method.py:37-48).
    """
    a_tiles = _tileize(in_edges, split) > 0
    b_tiles = _tileize(pred_edges, split) > 0
    n_tiles, th, tw = a_tiles.shape
    a = a_tiles.reshape(n_tiles, th * tw)
    b = b_tiles.reshape(n_tiles, th * tw)

    d = _tile_distances(th, tw)  # within-tile pairwise distances, shared across tiles

    big = np.float32(1e9)
    # d(a_i, B) per tile: min over j in B
    d_ab = np.where(b[:, None, :], d[None, :, :], big).min(axis=2)  # (T, t^2)
    d_ab = np.where(a, d_ab, -1.0)  # only A pixels count
    d_ba = np.where(a[:, None, :], d[None, :, :], big).min(axis=2)
    d_ba = np.where(b, d_ba, -1.0)

    h_ab = d_ab.max(axis=1)  # max over A of min-dist to B
    h_ba = d_ba.max(axis=1)
    hd = np.maximum(h_ab, h_ba)

    a_star = d_ab.argmax(axis=1)
    b_star = d_ba.argmax(axis=1)
    # when the B side dominates, witness = A-pixel nearest the extreme B-pixel
    d_rows = d[b_star]  # (T, t^2): distance from b_star cell to every cell
    d_rows = np.where(a, d_rows, big)
    a_near_b = d_rows.argmin(axis=1)
    witness = np.where(h_ab >= h_ba, a_star, a_near_b)

    empty_a = ~a.any(axis=1)
    empty_b = ~b.any(axis=1)
    both_valid = ~(empty_a | empty_b)
    diag = math.hypot(th, tw)

    dist = np.where(both_valid, hd, diag)
    # fallback witness: center of tile if A empty, else first A pixel
    center = (th // 2) * tw + tw // 2
    first_a = np.where(a.any(axis=1), a.argmax(axis=1), center)
    witness = np.where(both_valid, witness, np.where(empty_a, center, first_a))

    # to absolute image coordinates
    tile_r, tile_c = np.divmod(np.arange(n_tiles), split)
    wr = tile_r * th + witness // tw
    wc = tile_c * tw + witness % tw
    pts = np.stack([wr, wc], axis=1).astype(np.int64)
    return dist.astype(np.float32), pts


def _tiles_t(edges: torch.Tensor, split: int, th: int, tw: int) -> torch.Tensor:
    """(C, H, W) -> (C, split*split, th*tw) bool, as :func:`_tileize`."""
    c = edges.shape[0]
    tiles = edges[:, : th * split, : tw * split].reshape(c, split, th, split, tw)
    return tiles.permute(0, 1, 3, 2, 4).reshape(c, split * split, th * tw) > 0


def _hausdorff_chunk(a: torch.Tensor, b: torch.Tensor, d: torch.Tensor, th: int, tw: int):
    """:func:`tile_hausdorff` on (C, T, t^2) bool tile masks: (dist (C, T),
    witness (C, T) int64 cell index)."""
    big = torch.tensor(1e9, dtype=torch.float32, device=d.device)
    d_ab = torch.where(b[:, :, None, :], d, big).amin(dim=3)
    d_ab = torch.where(a, d_ab, -1.0)
    d_ba = torch.where(a[:, :, None, :], d, big).amin(dim=3)
    d_ba = torch.where(b, d_ba, -1.0)

    h_ab = d_ab.amax(dim=2)
    h_ba = d_ba.amax(dim=2)
    hd = torch.maximum(h_ab, h_ba)

    a_star = d_ab.argmax(dim=2)
    b_star = d_ba.argmax(dim=2)
    d_rows = torch.where(a, d[b_star], big)
    a_near_b = d_rows.argmin(dim=2)
    witness = torch.where(h_ab >= h_ba, a_star, a_near_b)

    any_a = a.any(dim=2)
    empty_a = ~any_a
    both_valid = ~(empty_a | ~b.any(dim=2))
    dist = torch.where(both_valid, hd, math.hypot(th, tw))
    center = (th // 2) * tw + tw // 2
    first_a = torch.where(any_a, a.to(torch.uint8).argmax(dim=2), center)
    witness = torch.where(both_valid, witness,
                          torch.where(empty_a, torch.full_like(witness, center), first_a))
    return dist, witness


def tile_hausdorff_batch(
    in_edges: np.ndarray,
    pred_edges: np.ndarray,
    split: int,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Batched, device-side :func:`tile_hausdorff`.

    ``in_edges``/``pred_edges``: (B, H, W) uint8 edge maps, copied to
    ``device`` (default ``cuda``). Returns (dist (B, T) f32, pts (B, T, 2) int64 -- absolute
    row/col witnesses) as numpy, equal to the per-image numpy path. The
    images run in chunks whose masked (chunk, T, t^2, t^2) transient stays
    under ``HAUSDORFF_CHUNK_BYTES``.
    """
    dev = resolve_device(device)
    a_all, b_all = (torch.from_numpy(np.ascontiguousarray(e)).to(dev)
                    for e in (in_edges, pred_edges))
    n, h, w = a_all.shape
    th, tw = h // split, w // split
    t2, n_tiles = th * tw, split * split
    d = torch.from_numpy(_tile_distances(th, tw)).to(dev)
    chunk = max(1, min(n, HAUSDORFF_CHUNK_BYTES // (n_tiles * t2 * t2 * 4)))
    log.info("tile_hausdorff_batch: %d maps of %dx%d, split %d, on %s in chunks of %d",
             n, h, w, split, dev, chunk)
    dists, witnesses = [], []
    for s in range(0, n, chunk):
        dist, witness = _hausdorff_chunk(_tiles_t(a_all[s: s + chunk], split, th, tw),
                                         _tiles_t(b_all[s: s + chunk], split, th, tw), d, th, tw)
        dists.append(dist)
        witnesses.append(witness)
    dist = torch.cat(dists).to(torch.float32)
    witness = torch.cat(witnesses)
    tile = torch.arange(n_tiles, device=dev)
    wr = (tile // split) * th + witness // tw
    wc = (tile % split) * tw + witness % tw
    pts = torch.stack([wr, wc], dim=-1).to(torch.int64)
    return dist.cpu().numpy(), pts.cpu().numpy()


def input_edge_map(image: np.ndarray) -> np.ndarray:
    """Canny edges of the input image (reference preprocessing chain:
    gray -> minmax -> medianBlur(15) -> auto-Canny)."""
    cv2 = _cv2()
    gray = cv2.cvtColor((image * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY)
    gray = _minmax(gray.astype(np.float32), 0, 255).astype(np.uint8)
    gray = cv2.medianBlur(gray, 15)
    return auto_canny(gray)


def pred_edge_map(pred: np.ndarray, sigma: float = 1.8) -> np.ndarray:
    """Canny edges of the predicted depth (minmax -> unsharp -> auto-Canny)."""
    cv2 = _cv2()
    pred_u8 = _minmax(np.squeeze(pred).astype(np.float32), 0, 255)
    blurred = cv2.GaussianBlur(pred_u8, (5, 5), 1.0)
    sharp = np.clip(4.0 * pred_u8 - 3.0 * blurred, 0, 255).round().astype(np.uint8)
    return auto_canny(sharp, sigma=sigma)


def acquire_pixels(
    image: np.ndarray,
    pred: np.ndarray,
    split: int = 32,
    sigma: float = 1.8,
) -> Tuple[np.ndarray, np.ndarray, float, float]:
    """One image -> (flat positions, (row, col) points, mean dist, var dist).

    Edge extraction mirrors the reference (active_learning_method.py:94-105):
    input: gray -> minmax -> medianBlur(15) -> auto-Canny; prediction:
    minmax -> unsharp mask -> auto-Canny(sigma).
    """
    h, w = image.shape[:2]
    in_edges = input_edge_map(image)
    pred_edges = pred_edge_map(pred, sigma)

    dist, pts = tile_hausdorff(in_edges, pred_edges, split)
    order = np.argsort(dist)  # ascending, as the reference sorts (:51)
    dist, pts = dist[order], pts[order]
    pos = (pts[:, 0] * w + pts[:, 1]).astype(np.int64)
    return pos, pts, float(dist.mean()), float(dist.var())


def oracle_label(
    gt: np.ndarray,
    pts: np.ndarray,
    ranking_size: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Group acquired pixels into K-lists labeled with ground-truth depth.

    Reference ``oracle`` (active_learning_method.py:59-76): shuffle, chunk
    into ranking_size lists, label with gt, sort each list depth-descending.
    Returns (n_lists, K, 2) float32 [flat_idx, depth].
    """
    h, w = gt.shape
    pts = pts.copy()
    rng.shuffle(pts)
    k = ranking_size
    n_lists = pts.shape[0] // k
    pts = pts[: n_lists * k]
    flat = (pts[:, 0] * w + pts[:, 1]).astype(np.float32).reshape(n_lists, k)
    depths = gt[pts[:, 0], pts[:, 1]].astype(np.float32).reshape(n_lists, k)
    order = np.argsort(-depths, axis=1)
    return np.stack(
        [np.take_along_axis(flat, order, axis=1),
         np.take_along_axis(depths, order, axis=1)],
        axis=-1,
    )

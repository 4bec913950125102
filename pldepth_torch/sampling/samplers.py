"""On-device depth-to-ranking samplers (``pldepth_tpu/sampling/samplers.py``).

Each image yields (RPI, K, 2) float32 rankings ``[flat_pixel_idx, gt_depth]``,
every list sorted by depth, descending. A batch is drawn at once: the JAX
package vmaps one image's sampler over the batch; here every op carries the
batch dimension.

The strategies keep their semantics (see the JAX module's docstring):
``purely_masked`` (no scoring), ``masked`` (adjacent spread),
``thresholded`` (spread + a -1000 penalty per "equal" adjacent pair),
``info_score`` (-chi^2 against linspace(min+1e-3, max, K+1)[1:] + the
penalty, oversample x5) and ``segment`` (each list draws from distinct
spatial-grid x depth-bin segments, scored like ``thresholded``).

The draw. ``hier``, ``packed`` and ``compact`` are TPU gather-cost devices
that give bit-identical draws for the same uniforms ``u``: each point is
"the g-th valid pixel in flat order" with ``g = min(int(f32(u * n_valid)),
n_valid - 1)``. Here all three (and ``auto``) are one GPU-native rank lookup,
an inclusive cumsum of the mask and ``torch.searchsorted``
(:func:`draw_from_uniform`), which takes ``u`` as an argument so tests can
hand it JAX's uniforms. ``rejection`` keeps its own method (16 candidate
draws per point, the first valid one). Unknown names raise (the JAX package
treats any other name as ``rejection``).

Random bits come from a ``torch.Generator`` on the data's device; they
differ from threefry's, so parity with the JAX package is exact given the
same uniforms or candidates, and distributional otherwise. Every draw's
shape depends on the batch size only (the rejection method's 16 rounds
too), so a ``core.mesh.RowsGenerator`` can draw at the global batch's
shape and keep one rank's rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from pldepth_torch.core.mesh import batch_rand, batch_randint
from pldepth_torch.sampling.relations import depth_relation

_EQUALITY_PENALTY = -1000.0
DRAW_METHODS = ("auto", "hier", "packed", "compact", "rejection")

# segment sampler geometry: GRID x GRID spatial cells x DEPTH_BINS depth bins
_SEG_GRID = 4
_SEG_DEPTH_BINS = 4


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    name: str
    oversample_factor: float  # candidate pool multiplier (reference bs_factor)
    scored: bool  # False => take the first RPI candidates unscored


SAMPLERS: Dict[str, SamplerSpec] = {
    "purely_masked": SamplerSpec("purely_masked", 1.0, scored=False),
    "masked": SamplerSpec("masked", 1.5, scored=True),
    "thresholded": SamplerSpec("thresholded", 1.5, scored=True),
    "info_score": SamplerSpec("info_score", 5.0, scored=True),
    "segment": SamplerSpec("segment", 1.5, scored=True),
}


def get_sampler(name: str) -> SamplerSpec:
    if name not in SAMPLERS:
        raise ValueError(f"unknown sampler {name!r}; have {sorted(SAMPLERS)}")
    return SAMPLERS[name]


def _check_draw_method(method: str) -> None:
    if method not in DRAW_METHODS:
        raise ValueError(f"unknown sampler_draw_method {method!r}; have {DRAW_METHODS}")


def _valid(mask_flat: torch.Tensor) -> torch.Tensor:
    """mask > 0 per image; an empty mask counts every pixel valid."""
    valid = mask_flat > 0
    return torch.where(valid.any(-1, keepdim=True), valid, torch.ones_like(valid))


def draw_from_uniform(u: torch.Tensor, mask_flat: torch.Tensor) -> torch.Tensor:
    """The rank-lookup draw: (B, n) uniforms in [0, 1) and (B, HW) masks ->
    (B, n) int64 flat indices, each "the g-th valid pixel" of its image."""
    csum = torch.cumsum(_valid(mask_flat).to(torch.int64), dim=-1)
    n_valid = csum[:, -1:]
    g = torch.minimum((u * n_valid.to(torch.float32)).to(torch.int64), n_valid - 1)
    return torch.searchsorted(csum, g + 1)


def masked_uniform_points(gen: torch.Generator, mask_flat: torch.Tensor, n_points: int,
                          method: str = "auto") -> torch.Tensor:
    """(B, n_points) flat indices drawn uniformly from each image's mask > 0
    (``_masked_uniform_points``)."""
    _check_draw_method(method)
    b, hw = mask_flat.shape
    dev = mask_flat.device
    if method != "rejection":
        u = batch_rand(gen, (b, n_points), dev)
        return draw_from_uniform(u, mask_flat)
    rounds = 16
    valid = _valid(mask_flat)
    cands = batch_randint(gen, hw, (b, rounds, n_points), dev)
    ok = torch.gather(valid, 1, cands.reshape(b, -1)).reshape(b, rounds, n_points)
    first = torch.argmax(ok.to(torch.int32), dim=1, keepdim=True)
    chosen = torch.gather(cands, 1, first)[:, 0]
    fallback = torch.argmax(valid.to(torch.int32), dim=-1, keepdim=True)
    return torch.where(ok.any(dim=1), chosen, fallback)


def _adjacent_equal_penalties(sorted_depths: torch.Tensor, threshold: float) -> torch.Tensor:
    rel = depth_relation(sorted_depths[..., :-1], sorted_depths[..., 1:], threshold)
    return _EQUALITY_PENALTY * (rel == 0).to(torch.float32).sum(-1)


def _segment_ids(gt: torch.Tensor, mask: torch.Tensor, grid: int, depth_bins: int):
    """Per-pixel segment id (spatial grid cell x depth bin), (B, HW); masked
    out pixels get the sentinel id S = number of segments."""
    b, hg, wg = gt.shape
    gy = torch.arange(hg, device=gt.device)[:, None]
    gx = torch.arange(wg, device=gt.device)[None, :]
    cell = (gy * grid // hg) * grid + (gx * grid // wg)
    lo = gt.amin(dim=(1, 2), keepdim=True)
    hi = gt.amax(dim=(1, 2), keepdim=True)
    dbin = torch.clamp(
        ((gt - lo) / torch.clamp(hi - lo, min=1e-6) * depth_bins).to(torch.int64),
        0, depth_bins - 1)
    seg = cell * depth_bins + dbin
    n_seg = grid * grid * depth_bins
    return torch.where(mask > 0, seg, torch.full_like(seg, n_seg)).reshape(b, -1), n_seg


def _segment_draw(gen, gt, mask, n_cand: int, k: int, draw_method: str) -> torch.Tensor:
    """(B, n_cand, k) flat gt-space indices, each list spanning distinct
    segments."""
    n_segments = _SEG_GRID * _SEG_GRID * _SEG_DEPTH_BINS
    if k > n_segments:
        raise ValueError(
            f"segment sampler draws at most one pixel per segment: "
            f"ranking_size {k} > {n_segments} segments "
            f"({_SEG_GRID}x{_SEG_GRID} tiles x {_SEG_DEPTH_BINS} depth bins); "
            f"use a smaller ranking_size or another sampling_type")
    seg_flat, n_seg = _segment_ids(gt, mask, _SEG_GRID, _SEG_DEPTH_BINS)
    b, hw = seg_flat.shape
    perm = torch.argsort(seg_flat, dim=-1, stable=True)
    counts = torch.zeros((b, n_seg + 1), dtype=torch.int64, device=gt.device)
    counts = counts.scatter_add_(1, seg_flat, torch.ones_like(seg_flat))[:, :n_seg]
    starts = torch.cumsum(counts, dim=-1) - counts

    seg_scores = batch_rand(gen, (b, n_cand, n_seg), gt.device)
    seg_scores = torch.where(counts[:, None, :] > 0, seg_scores, -1.0)
    chosen = torch.topk(seg_scores, k, dim=-1).indices.reshape(b, -1)  # (B, n_cand * k)
    u = batch_rand(gen, (b, n_cand * k), gt.device)
    cnt = torch.gather(counts, 1, chosen)
    offs = torch.gather(starts, 1, chosen) + (u * cnt.to(torch.float32)).to(torch.int64)
    idx = torch.gather(perm, 1, torch.clamp(offs, 0, hw - 1))
    # empty-segment fallback (fewer non-empty segments than k): global draw
    fallback = masked_uniform_points(gen, mask.reshape(b, -1), n_cand * k, draw_method)
    return torch.where(cnt > 0, idx, fallback).reshape(b, n_cand, k)


def _score_lists(name: str, sorted_depths: torch.Tensor, gt_min: torch.Tensor,
                 gt_max: torch.Tensor, threshold: float) -> torch.Tensor:
    """Per-candidate-list score (higher = kept). (B, C, K) -> (B, C);
    gt_min, gt_max: (B, 1, 1)."""
    diffs = (sorted_depths[..., :-1] - sorted_depths[..., 1:]).abs()
    if name == "masked":
        return diffs.sum(-1)
    if name in ("thresholded", "segment"):
        return diffs.sum(-1) + _adjacent_equal_penalties(sorted_depths, threshold)
    if name == "info_score":
        k = sorted_depths.shape[-1]
        # linspace(min+0.001, max, K+1)[1:], reference sampling.py:223
        lo = gt_min + 0.001
        steps = torch.arange(1, k + 1, dtype=torch.float32, device=sorted_depths.device)
        expected = lo + (gt_max - lo) * steps / k
        chi2 = (torch.square(sorted_depths - expected) / expected).sum(-1)
        return -chi2 + _adjacent_equal_penalties(sorted_depths, threshold)
    raise ValueError(f"no scoring rule for sampler {name!r}")


def rank_candidates(gidx: torch.Tensor, gts: torch.Tensor, *, sampler_name: str,
                    rankings_per_image: int, threshold: float = 0.03) -> torch.Tensor:
    """Candidate lists -> rankings: sort each list by depth (descending,
    stable), score, keep the top RPI (or the first RPI, unscored).

    gidx: (B, n_cand, K) flat gt-space pixel indices; gts: (B, H, W).
    Returns (B, RPI, K, 2) f32 ``[flat_idx, depth]``."""
    spec = get_sampler(sampler_name)
    b, n_cand, k = gidx.shape
    rpi = rankings_per_image
    gflat = gts.reshape(b, -1).to(torch.float32)
    depths = torch.gather(gflat, 1, gidx.reshape(b, -1)).reshape(b, n_cand, k)
    flat = gidx.to(torch.float32)
    order = torch.argsort(-depths, dim=-1, stable=True)
    depths = torch.take_along_dim(depths, order, dim=-1)
    flat = torch.take_along_dim(flat, order, dim=-1)
    if spec.scored:
        scores = _score_lists(sampler_name, depths, gflat.amin(-1)[:, None, None],
                              gflat.amax(-1)[:, None, None], threshold)
        # the first RPI of a stable descending order: ties go to the lower
        # index, as jax.lax.top_k puts them (torch.topk leaves them unordered)
        top = torch.argsort(-scores, dim=-1, stable=True)[..., :rpi, None]
        depths = torch.take_along_dim(depths, top, dim=1)
        flat = torch.take_along_dim(flat, top, dim=1)
    else:
        depths, flat = depths[:, :rpi], flat[:, :rpi]
    return torch.stack([flat, depths], dim=-1)


def mask_to_gt_index(midx: torch.Tensor, mask_hw, gt_hw) -> torch.Tensor:
    """Mask-space flat indices -> gt-space flat indices, rescaled by
    truncation as the reference does (sampling.py:115-116, int() cast)."""
    (hm, wm), (hg, wg) = mask_hw, gt_hw
    mx, my = midx // wm, midx % wm
    gx = torch.clamp((mx * hg) // hm, max=hg - 1)
    gy = torch.clamp((my * wg) // wm, max=wg - 1)
    return gx * wg + gy


def sample_rankings_batch(gen: torch.Generator, gts: torch.Tensor, masks: torch.Tensor, *,
                          sampler_name: str, rankings_per_image: int, ranking_size: int,
                          threshold: float = 0.03, oversample_factor: Optional[float] = None,
                          draw_method: str = "auto") -> torch.Tensor:
    """(B, RPI, K, 2) rankings for (B, H, W) ground truths and masks (the
    mask may have another resolution than gt). ``gen`` lives on the data's
    device."""
    spec = get_sampler(sampler_name)
    _check_draw_method(draw_method)
    factor = oversample_factor if oversample_factor is not None else spec.oversample_factor
    rpi, k = rankings_per_image, ranking_size
    n_cand = max(int(rpi * factor), rpi)
    gts = gts.to(torch.float32)
    masks = masks.to(torch.float32)
    b, hg, wg = gts.shape
    hm, wm = masks.shape[1:]
    if hg * wg > 1 << 24:
        # flat indices ride in the float32 rankings array; float32 is
        # integer-exact only up to 2^24
        raise ValueError(
            f"gt resolution {hg}x{wg} = {hg * wg} pixels exceeds the "
            f"float32-exact flat-index range (2^24 = {1 << 24}); use "
            f"input_size < 4096")
    if sampler_name == "segment":
        if (hm, wm) != (hg, wg):
            ri = torch.arange(hg, device=gts.device) * hm // hg
            ci = torch.arange(wg, device=gts.device) * wm // wg
            masks = masks[:, ri[:, None], ci[None, :]]
        gidx = _segment_draw(gen, gts, masks, n_cand, k, draw_method)
    else:
        midx = masked_uniform_points(gen, masks.reshape(b, -1), n_cand * k, draw_method)
        gidx = mask_to_gt_index(midx, (hm, wm), (hg, wg)).reshape(b, n_cand, k)
    return rank_candidates(gidx, gts, sampler_name=sampler_name,
                           rankings_per_image=rpi, threshold=threshold)

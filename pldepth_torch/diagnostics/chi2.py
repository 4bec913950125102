"""Chi^2 sampling-informativeness diagnostic (``pldepth_tpu/diagnostics/chi2.py``).

Rebuild of pldepth/chi2compare.py:27-165: how close each sampling strategy's
ranking lists come to an ideal uniform depth spread. For each trial, sample
``batches_per_trial`` batches, score every list with

    chi2 = sum((gt_depths - linspace(0.001, 0.999, K+1)[1:])^2 / expected)

(reference compute_chi_sq, chi2compare.py:27-37), average per batch, then
report mean and variance across trials. The batches are the JAX package's
(``BatchIterator``: the same permutation stream); the lists are drawn on the
device by ``sample_rankings_batch`` with a generator keyed by (seed + trial,
b), so they follow the same distribution as JAX's but not its bits.
``compute_chi_sq`` and ``ranking_stats`` are copies of the JAX package's
numpy.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pldepth_torch.core.config import ExperimentConfig, sampler_name_for_type
from pldepth_torch.core.device import DeviceLike, resolve_device
from pldepth_torch.core.rng import generator
from pldepth_torch.data import BatchIterator, get_dataset
from pldepth_torch.sampling import sample_rankings_batch


def compute_chi_sq(rankings: np.ndarray, ranking_size: int) -> float:
    """rankings: (N, K, 2) -> mean chi^2 against the fixed ideal spread."""
    expected = np.linspace(0.001, 0.999, ranking_size + 1)[1:]
    gts = rankings[..., 1]
    return float((np.square(gts - expected) / expected).sum(axis=-1).mean())


def ranking_stats(rankings: np.ndarray, threshold: float = 0.03) -> Dict[str, float]:
    """Distributional summary of a set of ranking lists (the sampler
    parity protocol of tools/sampler_parity_check.py, after the
    chi2compare.py:139-161 idea).

    rankings: (N, K, 2) with [..., 1] the ground-truth depths per list.
    Returns: chi2 (informativeness vs the fixed ideal spread), spread (mean
    sum of adjacent |depth diffs|), eq_frac (fraction of adjacent pairs that
    are near-equal under the reference ratio test, depth_utils.py:5-21),
    sorted_frac (fraction of adjacent pairs in descending order).
    """
    gts = np.asarray(rankings)[..., 1]
    diffs = np.diff(gts, axis=-1)
    eps = 1e-10
    hi = np.maximum(gts[..., :-1], gts[..., 1:])
    lo = np.minimum(gts[..., :-1], gts[..., 1:])
    ratio = (hi + eps) / (lo + eps)
    return {
        "chi2": compute_chi_sq(np.asarray(rankings), gts.shape[-1]),
        "spread": float(np.abs(diffs).sum(axis=-1).mean()),
        "eq_frac": float((ratio < 1.0 + threshold).mean()),
        "sorted_frac": float((diffs <= 1e-9).mean()),
    }


def run_chi2_compare(cfg: ExperimentConfig, trials: int = 5, batches_per_trial: int = 25,
                     device: DeviceLike = None) -> Dict[str, float]:
    """Mean and variance over ``trials`` of the per-trial mean chi^2 of
    ``cfg``'s sampler (``cfg.sampling_type``), sampling on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    sampler = sampler_name_for_type(cfg.sampling_type)
    if cfg.dataset.lower() in ("hr-wsi", "hr_wsi", "hrwsi"):
        ds = get_dataset("HR-WSI", root=cfg.data_root, split="train",
                         size=cfg.ds_size or 1000, target_size=cfg.input_size)
    else:
        ds = get_dataset("synthetic", size=cfg.ds_size or 64,
                         target_size=cfg.input_size, seed=cfg.seed)

    scores = []
    for trial in range(trials):
        it = BatchIterator(ds, cfg.batch_size, seed=cfg.seed + trial)
        batch_scores = []
        try:
            for b in range(batches_per_trial):
                batch = next(it)
                r = sample_rankings_batch(
                    generator(cfg.seed + trial, "chi2", b, dev),
                    torch.from_numpy(batch["gt"]).to(dev),
                    torch.from_numpy(batch["mask"]).to(dev),
                    sampler_name=sampler,
                    rankings_per_image=cfg.rankings_per_image,
                    ranking_size=cfg.ranking_size,
                    threshold=cfg.equality_threshold,
                ).cpu().numpy()
                batch_scores.append(
                    compute_chi_sq(r.reshape(-1, cfg.ranking_size, 2), cfg.ranking_size))
        finally:
            it.close()
        scores.append(float(np.mean(batch_scores)))
    return {
        "sampler": sampler,
        "mean": float(np.mean(scores)),
        "variance": float(np.var(scores)),
        "trials": scores,
    }

"""Active-learning training loop (``pldepth_tpu/active/loop.py``).

Replaces the reference round drivers (run_scripts/active_PLDepth.py:160-185,
active_on_base.py:129-147): after (or instead of) base pretraining, run N
rounds of [acquire disagreement pixels -> oracle-label rankings -> fit one
epoch on the acquired pool], tracking per-round ordinal error.

One device: the resident path forwards the store's own rows in order, with
an overlapping tail batch (the JAX package's one-device mesh). Each fit step
is ``Trainer.train_step_fixed``, whose loss runs on K1 on the card.
"""

from __future__ import annotations

import itertools
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pldepth_torch.active.acquisition import (
    input_edge_map,
    oracle_label,
    pred_edge_map,
    tile_hausdorff_batch,
)
from pldepth_torch.data.datasets import DepthDataset

log = logging.getLogger(__name__)


def _stream_batches(trainer, state, ds, predict_batch, row_subset=None):
    """Yield (rows, items, preds) per predict batch, images uploaded from
    the host. The forward is queued without waiting: the caller fetches one
    batch ahead so the device forward overlaps the host-side Canny work (the
    reference blocked per image, active_learning_method.py:101).
    ``row_subset`` restricts to specific dataset rows (the part of the pool
    a resident store does not hold)."""
    from pldepth_torch.train.trainer import pad_to_batch

    predict = trainer.jit_predict()
    all_rows = list(range(len(ds))) if row_subset is None else list(row_subset)
    for start in range(0, len(all_rows), predict_batch):
        rows = all_rows[start: start + predict_batch]
        items = [ds[i] for i in rows]
        imgs = np.stack([s["image"] for s in items])
        yield rows, items, predict(state, pad_to_batch(imgs, predict_batch))


def _resident_batches(trainer, state, ds, store, predict_batch):
    """Yield (rows, items, preds) with the forward reading images straight
    out of the resident store: no per-batch host-to-device image traffic
    (only predictions come back). The last batch overlaps rows already
    covered when ``predict_batch`` does not divide the store (the caller
    skips them)."""
    n_local = store.n
    bl = max(1, min(predict_batch, n_local))
    predict_r = trainer.jit_predict_resident(bl)
    starts = list(range(0, n_local - bl + 1, bl))
    if starts[-1] + bl < n_local:
        starts.append(n_local - bl)  # overlapping tail
    for start in starts:
        rows = [start + j for j in range(bl)]
        items = [ds[i] for i in rows]
        yield rows, items, predict_r(state, store.arrays["image"], start)


def active_learning_round(
    trainer,
    state,
    ds: DepthDataset,
    *,
    split: int = 32,
    sigma: float = 1.8,
    seed: int = 0,
    predict_batch: int = 8,
    store=None,
):
    """Acquire + oracle-label the whole pool -> arrays for fixed-ranking fit.

    ``store``: optional ResidentStore holding the pool -- predictions then
    read images from device memory instead of uploading them every batch.
    Returns (images (N,H,W,3), rankings (N, L, K, 2), stats dict).
    """
    k = trainer.cfg.ranking_size
    rng = np.random.default_rng(seed)
    by_row = {}  # row -> (image, lists, mean, var)

    if store is not None:
        gen = _resident_batches(trainer, state, ds, store, predict_batch)
        if store.n < len(ds):
            # a store built from part of the pool: cover the rest by
            # streaming, or those rows would drop out of every round
            log.info(
                "resident store covers %d/%d pool rows; streaming the "
                "%d-row remainder", store.n, len(ds), len(ds) - store.n,
            )
            gen = itertools.chain(
                gen,
                _stream_batches(trainer, state, ds, predict_batch,
                                row_subset=range(store.n, len(ds))),
            )
    else:
        gen = _stream_batches(trainer, state, ds, predict_batch)

    pending = next(gen)
    while pending is not None:
        rows, items, preds_dev = pending
        pending = next(gen, None)  # queue the next batch's forward first
        # host Canny on the inputs runs while the device computes; rows seen
        # before (the overlapping tail) are skipped before they draw from rng
        keep = [j for j, r in enumerate(rows) if r not in by_row]
        in_edges = np.stack([input_edge_map(items[j]["image"]) for j in keep])
        preds = np.asarray(preds_dev)  # waits for this batch only
        pred_edges = np.stack([pred_edge_map(preds[j], sigma) for j in keep])
        # one device call per batch in place of the per-image numpy Hausdorff
        dist_b, pts_b = tile_hausdorff_batch(in_edges, pred_edges, split, trainer.device)
        for jj, j in enumerate(keep):
            s = items[j]
            dist, pts = dist_b[jj], pts_b[jj]
            lists = oracle_label(s["gt"], pts, k, rng)
            by_row[rows[j]] = (
                s["image"], lists, float(dist.mean()), float(dist.var())
            )

    ordered = [by_row[r] for r in sorted(by_row)]
    stats = {
        "avg_hd_mean": float(np.mean([t[2] for t in ordered])),
        "avg_hd_var": float(np.mean([t[3] for t in ordered])),
    }
    images = np.stack([t[0] for t in ordered])
    rankings = np.stack([t[1] for t in ordered]).astype(np.float32)
    return images, rankings, stats


def fit_on_fixed_rankings(trainer, state, images, rankings, steps: int, seed: int = 0):
    """One epoch of fixed-ranking training (reference: model.fit on the
    active dataset for one epoch per round): at most ``steps`` batches of a
    ``numpy.default_rng(seed)`` permutation, each through
    ``train_step_fixed``; at most two steps in flight on the card."""
    n = images.shape[0]
    bs = trainer.cfg.batch_size
    order = np.random.default_rng(seed).permutation(n)
    metrics = []
    for b in range(min(n // bs, steps)):
        idx = order[b * bs: (b + 1) * bs]
        state, m = trainer.train_step_fixed(
            state, {"image": images[idx], "rankings": rankings[idx]})
        metrics.append(m)
        if len(metrics) >= 2 and metrics[-2].done is not None:
            metrics[-2].done.synchronize()
    if not metrics:
        return state, float("nan")
    losses = [float(x) for x in torch.stack([m.loss for m in metrics]).cpu()]
    return state, float(np.mean(losses))


def run_active_loop(
    trainer,
    state,
    pool: DepthDataset,
    *,
    rounds: int = 6,
    split: int = 32,
    sigma: float = 1.8,
    eval_ds: Optional[DepthDataset] = None,
    eval_limit: Optional[int] = 50,
    seed: int = 0,
    logger=None,
    store=None,
) -> Tuple["TrainState", Dict[str, List[float]]]:
    """The full loop: reference active_PLDepth.py:160-185 semantics."""
    from pldepth_torch.eval.evaluator import Evaluator

    history: Dict[str, List[float]] = {"loss": [], "err": [], "hd_mean": []}
    for r in range(rounds):
        images, rankings, stats = active_learning_round(
            trainer, state, pool, split=split, sigma=sigma, seed=seed + r,
            store=store,
        )
        steps = max(1, images.shape[0] // trainer.cfg.batch_size)
        state, loss = fit_on_fixed_rankings(
            trainer, state, images, rankings, steps, seed=seed + r
        )
        history["loss"].append(loss)
        history["hd_mean"].append(stats["avg_hd_mean"])
        if eval_ds is not None:
            err = Evaluator(trainer, state).calc_err(eval_ds, limit=eval_limit)
            history["err"].append(err)
        log.info(
            "active round %d: loss=%.4f hd_mean=%.2f err=%s",
            r, loss, stats["avg_hd_mean"],
            f"{history['err'][-1]:.4f}" if eval_ds is not None else "-",
        )
        if logger is not None:
            logger.log({"active_round": r, "active_loss": loss, **stats})
    return state, history

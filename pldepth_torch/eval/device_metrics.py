"""Batched evaluation metrics on the device (``pldepth_tpu/eval/device_metrics.py``):
ordinal error / WHDR(tau) / NDCG@k over a batch of maps that stay where
they were predicted; the host receives three scalars per image.

The formulas are those of the host path (eval/metrics.py), in float32 as
in the JAX package (x64 off there). Pixels are drawn with a
``torch.Generator`` on the maps' device, a different stream than both the
host's ``np.random.RandomState(10)`` and ``jax.random``, so the values track
the host path statistically (for 5000 pairs the sampling noise on an error
rate p is ~sqrt(p(1-p)/5000) < 0.008), not bitwise. The scoring is exact:
given the same indices, ``pairwise_disagreement`` equals the JAX function,
and ``ndcg_sampled`` equals it to the rounding of ``log2`` (XLA's and
PyTorch's differ by up to 4.8e-7 at list size 200).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def _mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis as XLA's: the sum divided by the count. On
    CUDA, ``mean`` and a division by a Python number multiply by the
    reciprocal (one float32 ulp off at times), so the count is a tensor."""
    total = x.sum(-1)
    return total / torch.full_like(total, x.shape[-1])


def pairwise_disagreement(pred_flat: torch.Tensor, gt_flat: torch.Tensor, i0: torch.Tensor,
                          i1: torch.Tensor, tau: float = 0.0,
                          invert_pred_order: bool = False) -> torch.Tensor:
    """Fraction of index pairs whose predicted relation disagrees with gt.

    One image (``(n,)`` maps, ``(P,)`` indices, a scalar out) or a batch
    (``(B, n)`` maps, ``(B, P)`` indices, ``(B,)`` out). tau=0: strict
    order comparison (reference ordinal_error, metrics.py:60-70). tau>0: the
    ratio relation of depth_utils.py:5-21 (ratio >= 1+tau -> 1, <=
    1/(1+tau) -> -1, else 0) on both maps, the ratio in float32 against the
    Python scalars, as JAX compares it.
    """
    i0, i1 = i0.long(), i1.long()
    p0, p1 = pred_flat.gather(-1, i0), pred_flat.gather(-1, i1)
    g0, g1 = gt_flat.gather(-1, i0), gt_flat.gather(-1, i1)
    if tau == 0.0:
        pred_order = p0 > p1
        if invert_pred_order:
            pred_order = ~pred_order
        return 1.0 - _mean((pred_order == (g0 > g1)).float())
    eps = 1e-10

    def rel(a, b):
        ratio = (a.float() + eps) / (b.float() + eps)
        return torch.where(ratio >= 1 + tau, 1,
                           torch.where(ratio <= 1 / (1 + tau), -1, 0))

    r_gt = rel(g0, g1)
    r_pred = rel(p0, p1)
    if invert_pred_order:
        r_pred = -r_pred
    return _mean((r_gt != r_pred).float())


def _draw(gen: torch.Generator, b: int, n: int, k: int) -> torch.Tensor:
    """(b, k) flat indices, distinct within each row (the reference's
    replace=False draw, metrics.py:62): the first k of a sort of uniform
    keys, one row of keys per image."""
    keys = torch.rand(b, n, generator=gen, device=gen.device)
    return keys.argsort(dim=-1)[:, :k]


def _draw_pairs(gen: torch.Generator, b: int, n: int,
                num_pairs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """2*num_pairs distinct flat indices per image, split in two halves."""
    idx = _draw(gen, b, n, 2 * num_pairs)
    return idx[:, :num_pairs], idx[:, num_pairs:]


def _minmax01(x: torch.Tensor) -> torch.Tensor:
    lo = x.amin(-1, keepdim=True)
    hi = x.amax(-1, keepdim=True)
    return torch.where(hi - lo < 1e-12, torch.zeros_like(x), (x - lo) / (hi - lo))


def _dcg(rel: torch.Tensor) -> torch.Tensor:
    pos = torch.arange(rel.shape[-1], dtype=torch.float32, device=rel.device)
    return (rel / torch.log2(pos + 2.0)).sum(-1)


def ndcg_sampled(pred_flat: torch.Tensor, gt_flat: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """NDCG@|ids| with relevance 1/(depth+1), pred minmax-normalized; one
    image or a batch, as ``pairwise_disagreement``.

    Same formula as the host ndcg_at_k (reference calc_d,
    metrics.py:92-109), including the faithful quirk that both lists are
    sorted by their own values.
    """
    ids = ids.long()
    sorted_pred = _minmax01(pred_flat.float()).gather(-1, ids).sort(-1).values
    sorted_gt = gt_flat.float().gather(-1, ids).sort(-1).values
    return _dcg(1.0 / (sorted_pred + 1.0)) / _dcg(1.0 / (sorted_gt + 1.0))


def eval_metrics_batch(gen: torch.Generator, preds: torch.Tensor, gts: torch.Tensor,
                       num_pairs: int = 5000, tau: float = 0.03,
                       invert_pred_order: bool = False,
                       ndcg_list_size: int = 200) -> Dict[str, torch.Tensor]:
    """Per-image device metrics for a batch of maps.

    Args:
      gen: generator on the maps' device (pair and pixel draws; one per
        batch for determinism, core/rng.py).
      preds: (B, H, W) predicted depth maps.
      gts: (B, H, W) ground-truth maps.

    Returns:
      dict of (B,) float32 tensors: ordinal_error, whdr (at ``tau``), ndcg.
    """
    b = preds.shape[0]
    n = preds.shape[1] * preds.shape[2]
    num_pairs = min(num_pairs, n // 2)
    ndcg_list_size = min(ndcg_list_size, n)
    pf = preds.reshape(b, n)
    gf = gts.reshape(b, n)
    i0, i1 = _draw_pairs(gen, b, n, num_pairs)
    ids = _draw(gen, b, n, ndcg_list_size)
    return {
        "ordinal_error": pairwise_disagreement(pf, gf, i0, i1, 0.0, invert_pred_order),
        "whdr": pairwise_disagreement(pf, gf, i0, i1, tau, invert_pred_order),
        "ndcg": ndcg_sampled(pf, gf, ids),
    }

"""Plackett-Luce ListMLE negative log-likelihood
(``pldepth_tpu/ops/listmle.py``).

Positions of each list are ordered by label, descending (a stable argsort of
-labels, ties by position, NaN labels last); the NLL of a list is
``sum_i [log sum_{j>=i} exp(s_pi(j)) - s_pi(i)]``. Everything runs in f32.
Ranked pixels are gathered by the rule of ``jnp.take_along_axis``: a
negative index wraps once, one still outside the map reads NaN (so the
loss is NaN and the trainer's finite guard refuses the step) and gets no
gradient.

Two implementations, chosen by ``impl`` (core/device.py:resolve_impl):
``"pallas"`` runs K1, the hand-written CUDA kernels (ops/listmle_kernel.py):
:func:`pl_ranking_loss` is one fused launch forward (gather, label sort,
NLL, mean) and one backward (the gradient map); :func:`listmle_nll` sorts
in PyTorch and runs the sorted kernels. ``"xla"`` runs the plain PyTorch
chain with autograd's backward (the twin of the JAX package's ``xla``
loss). ``"auto"`` is the kernel on CUDA and the plain version on the CPU.
"""

from __future__ import annotations

import torch

from pldepth_torch.core.device import resolve_impl, wide
from pldepth_torch.ops.listmle_kernel import (  # noqa: F401  (gather_ranked_scores: API)
    gather_ranked_scores,
    listmle_fwd_plain,
    listmle_sorted,
    ranking_loss,
    ranking_loss_plain,
    sort_by_labels_desc,
)


def listmle_sorted_plain(s: torch.Tensor) -> torch.Tensor:
    """NLL of label-sorted lists, plain PyTorch. s: (N, K) -> (N,) f32
    (float64 for float64 scores, as ``ranking_loss_plain``)."""
    return listmle_fwd_plain(wide(s))[0]


def listmle_nll(scores: torch.Tensor, labels: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Per-list Plackett-Luce NLL. scores, labels: (N, K) -> (N,) f32 (the
    plain version keeps float64 scores in float64)."""
    if scores.shape != labels.shape:
        raise ValueError(f"shape mismatch {tuple(scores.shape)} vs {tuple(labels.shape)}")
    s = sort_by_labels_desc(wide(scores), labels)
    if resolve_impl(impl, scores.device) == "pallas":
        return listmle_sorted(s)
    return listmle_sorted_plain(s)


def pl_ranking_loss(pred_maps: torch.Tensor, rankings: torch.Tensor,
                    impl: str = "auto") -> torch.Tensor:
    """Mean ListMLE loss of predicted (B, H, W[, 1]) maps against (B, RPI,
    K, 2) f32 rankings ([..., 0] flat pixel index, [..., 1] ground-truth
    depth)."""
    if resolve_impl(impl, pred_maps.device) == "pallas":
        return ranking_loss(pred_maps, rankings)
    return ranking_loss_plain(pred_maps, rankings)


def pl_ranking_loss_from_scores(scores: torch.Tensor, rankings: torch.Tensor,
                                impl: str = "auto") -> torch.Tensor:
    """Mean ListMLE loss from pre-gathered (B, RPI * K) scores in the order
    of ``rankings[..., 0]``."""
    k = rankings.shape[-2]
    gt_depths = rankings[..., 1].reshape(-1, k)
    return listmle_nll(scores.reshape(-1, k), gt_depths, impl=impl).mean()

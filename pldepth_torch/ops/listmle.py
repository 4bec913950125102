"""Plackett-Luce ListMLE negative log-likelihood
(``pldepth_tpu/ops/listmle.py``).

Positions of each list are ordered by label, descending (a stable argsort of
-labels, ties by position); the NLL of a list is
``sum_i [log sum_{j>=i} exp(s_pi(j)) - s_pi(i)]``. Everything runs in f32.

Two implementations, chosen by ``impl`` (core/device.py:resolve_impl):
``"pallas"`` runs K1, the hand-written CUDA kernel with its backward kernel
(ops/listmle_kernel.py); ``"xla"`` runs :func:`listmle_sorted_plain`, reverse
``torch.logcumsumexp`` with autograd's backward (the twin of
``_listmle_sorted_xla``). ``"auto"`` is the kernel on CUDA and the plain
version on the CPU.
"""

from __future__ import annotations

import torch

from pldepth_torch.core.device import resolve_impl
from pldepth_torch.ops.listmle_kernel import listmle_sorted


def _sort_by_labels_desc(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    order = torch.argsort(-labels, dim=-1, stable=True)
    return torch.take_along_dim(scores, order, dim=-1)


def listmle_sorted_plain(s: torch.Tensor) -> torch.Tensor:
    """NLL of label-sorted lists, plain PyTorch. s: (N, K) -> (N,)."""
    s = s.to(torch.float32)
    lse = torch.logcumsumexp(s.flip(-1), dim=-1).flip(-1)
    return (lse - s).sum(-1)


def listmle_nll(scores: torch.Tensor, labels: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Per-list Plackett-Luce NLL. scores, labels: (N, K) -> (N,) f32."""
    if scores.shape != labels.shape:
        raise ValueError(f"shape mismatch {tuple(scores.shape)} vs {tuple(labels.shape)}")
    s = _sort_by_labels_desc(scores.to(torch.float32), labels)
    if resolve_impl(impl, scores.device) == "pallas":
        return listmle_sorted(s)
    return listmle_sorted_plain(s)


def gather_ranked_scores(pred_maps: torch.Tensor, point_idx: torch.Tensor) -> torch.Tensor:
    """Predicted depths at flat ``x * W + y`` pixel indices.

    pred_maps: (B, H, W) or (B, H, W, 1); point_idx: (B, RPI, K) integer.
    Returns (B * RPI, K); the backward is autograd's scatter-add."""
    b = pred_maps.shape[0]
    flat = pred_maps.reshape(b, -1)
    k = point_idx.shape[-1]
    sel = torch.gather(flat, 1, point_idx.reshape(b, -1).long())
    return sel.reshape(-1, k)


def pl_ranking_loss(pred_maps: torch.Tensor, rankings: torch.Tensor,
                    impl: str = "auto") -> torch.Tensor:
    """Mean ListMLE loss of predicted maps against (B, RPI, K, 2) f32
    rankings ([..., 0] flat pixel index, [..., 1] ground-truth depth)."""
    point_idx = rankings[..., 0].to(torch.int64)
    gt_depths = rankings[..., 1].reshape(-1, rankings.shape[-2])
    scores = gather_ranked_scores(pred_maps, point_idx)
    return listmle_nll(scores, gt_depths, impl=impl).mean()


def pl_ranking_loss_from_scores(scores: torch.Tensor, rankings: torch.Tensor,
                                impl: str = "auto") -> torch.Tensor:
    """Mean ListMLE loss from pre-gathered (B, RPI * K) scores in the order
    of ``rankings[..., 0]``."""
    k = rankings.shape[-2]
    gt_depths = rankings[..., 1].reshape(-1, k)
    return listmle_nll(scores.reshape(-1, k), gt_depths, impl=impl).mean()

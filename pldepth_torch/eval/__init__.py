"""Evaluation: host metrics, device metrics, the Evaluator and DIW."""

from pldepth_torch.eval.device_metrics import (
    eval_metrics_batch,
    ndcg_sampled,
    pairwise_disagreement,
)
from pldepth_torch.eval.evaluator import Evaluator
from pldepth_torch.eval.metrics import depth_edge_metric, ndcg_at_k, ordinal_error, whdr

__all__ = [
    "Evaluator",
    "depth_edge_metric",
    "eval_metrics_batch",
    "ndcg_at_k",
    "ndcg_sampled",
    "ordinal_error",
    "pairwise_disagreement",
    "whdr",
]

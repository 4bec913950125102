"""Batched evaluation over datasets, incl. the zero-shot cross-dataset suite
(``pldepth_tpu/eval/evaluator.py``).

Replaces the reference's per-image predict loops (calc_err/dcg_metric/
calc_depth_metrics, pldepth/active_learning/metrics.py:73-155, and
test_data_eval.py:30-104) with batched inference on the device; the metric
arithmetic is the reference's (eval/metrics.py), so a report equals the JAX
package's on the same predictions.

Zero-shot convention: HR-WSI gt is descending (closer = larger), while
Ibims/Sintel/DIODE/TUM are ascending (reference pl_hourglass.py:22-31) --
the evaluator flips the predicted order for ascending datasets via
``ds.asc_depth_order``.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from pldepth_torch.core.rng import generator
from pldepth_torch.data.datasets import DepthDataset
from pldepth_torch.eval import metrics as M
from pldepth_torch.eval.device_metrics import eval_metrics_batch
from pldepth_torch.train.trainer import pad_to_batch

log = logging.getLogger(__name__)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Evaluator:
    def __init__(self, trainer, state, eval_batch_size: int = 8):
        self.trainer = trainer
        self.state = state
        self.batch_size = eval_batch_size
        # Duck-typed: any object with a predict(state, images) works
        # (model-free predictors in tests). A Trainer's serving callable
        # queues each batch's copy to the host behind its forward.
        if hasattr(trainer, "jit_predict"):
            self._predict = trainer.jit_predict()
        else:
            self._predict = trainer.predict

    def _predict_dataset(self, ds: DepthDataset, limit: Optional[int] = None):
        n = min(len(ds), limit) if limit is not None else len(ds)
        for start in range(0, n, self.batch_size):
            items = [ds[i] for i in range(start, min(start + self.batch_size, n))]
            images = pad_to_batch(np.stack([s["image"] for s in items]), self.batch_size)
            preds = _host(self._predict(self.state, images))
            for j, s in enumerate(items):
                yield preds[j], s["gt"]

    # -- reference-equivalent aggregate metrics ---------------------------
    def calc_err(self, ds: DepthDataset, limit: Optional[int] = None, tau: float = 0.0) -> float:
        """Mean ordinal error (reference calc_err, metrics.py:73-80)."""
        errs = [
            M.ordinal_error(p, g, invert_pred_order=ds.asc_depth_order)
            if tau == 0.0
            else M.whdr(p, g, tau=tau, invert_pred_order=ds.asc_depth_order)
            for p, g in self._predict_dataset(ds, limit)
        ]
        return float(np.mean(errs))

    def dcg_metric(self, ds: DepthDataset, list_size: int = 200,
                   limit: Optional[int] = None) -> float:
        vals = [M.ndcg_at_k(p, g, list_size=list_size)
                for p, g in self._predict_dataset(ds, limit)]
        return float(np.mean(vals))

    def calc_depth_metrics(self, ds: DepthDataset, limit: Optional[int] = None):
        pairs = [M.depth_edge_metric(p, g) for p, g in self._predict_dataset(ds, limit)]
        arr = np.asarray(pairs, np.float64)
        arr = arr[np.all(np.isfinite(arr), axis=1)]
        return float(arr[:, 0].mean()), float(arr[:, 1].mean())

    def full_report(self, ds: DepthDataset, limit: Optional[int] = None,
                    tau: float = 0.03) -> Dict[str, float]:
        """test_data_eval.py equivalent: ordinal error, WHDR(tau), NDCG@200,
        boundary + completeness (the last two only where cv2 is present)."""
        preds = list(self._predict_dataset(ds, limit))
        inv = ds.asc_depth_order
        report = {
            "test_error": float(
                np.mean([M.ordinal_error(p, g, invert_pred_order=inv) for p, g in preds])),
            f"whdr_tau_{tau}": float(
                np.mean([M.whdr(p, g, tau=tau, invert_pred_order=inv) for p, g in preds])),
            "ndcg_200": float(np.mean([M.ndcg_at_k(p, g) for p, g in preds])),
        }
        try:
            edges = np.asarray([M.depth_edge_metric(p, g) for p, g in preds])
        except RuntimeError:  # cv2 missing: the report has no edge keys
            return report
        edges = edges[np.all(np.isfinite(edges), axis=1)]
        if len(edges):  # all-smooth maps can yield zero Canny edges
            report["depth_boundary_metric"] = float(edges[:, 0].mean())
            report["depth_completeness"] = float(edges[:, 1].mean())
        return report

    def full_report_device(self, ds: DepthDataset, limit: Optional[int] = None,
                           tau: float = 0.03, seed: int = 0) -> Dict[str, float]:
        """full_report on the device path (eval/device_metrics.py).

        The predictions stay where ``trainer.predict`` made them and the
        metrics run there; the host receives three scalars per image.
        Pixels are drawn per batch from a generator keyed by (seed, batch
        index), so values track the host (reference-seeded) path to within
        sampling noise (~0.008 at 5000 pairs), not bitwise. No edge
        metrics (cv2 Canny has no device version): use full_report for
        those.
        """
        inv = ds.asc_depth_order
        n = min(len(ds), limit) if limit else len(ds)
        per_image: List[np.ndarray] = []
        for bi, start in enumerate(range(0, n, self.batch_size)):
            items = [ds[i] for i in range(start, min(start + self.batch_size, n))]
            images = pad_to_batch(np.stack([s["image"] for s in items]), self.batch_size)
            gts = np.stack([np.squeeze(np.asarray(s["gt"])) for s in items])
            # one batch shape; padded rows are discarded
            gts = pad_to_batch(gts, self.batch_size, fill=1.0)
            with torch.inference_mode():
                preds = torch.as_tensor(self.trainer.predict(self.state, images))
                m = eval_metrics_batch(
                    generator(seed, "eval_metrics", bi, device=preds.device), preds,
                    torch.as_tensor(gts, dtype=torch.float32).to(preds.device), tau=tau,
                    invert_pred_order=inv)
                host = torch.stack([m["ordinal_error"], m["whdr"], m["ndcg"]]).cpu().numpy()
            per_image.append(host[:, : len(items)])
        oe, wh, nd = np.concatenate(per_image, axis=1)
        return {
            "test_error": float(np.mean(oe)),
            f"whdr_tau_{tau}": float(np.mean(wh)),
            "ndcg_200": float(np.mean(nd)),
        }

    def zero_shot_suite(self, datasets: Iterable[DepthDataset],
                        limit: Optional[int] = None) -> Dict[str, Dict[str, float]]:
        """Cross-dataset ordinal eval (BASELINE.json config #4)."""
        out = {}
        for ds in datasets:
            # one inference pass scores both metrics
            inv = ds.asc_depth_order
            errs, whdrs = [], []
            for p, g in self._predict_dataset(ds, limit):
                errs.append(M.ordinal_error(p, g, invert_pred_order=inv))
                whdrs.append(M.whdr(p, g, tau=0.03, invert_pred_order=inv))
            out[ds.name] = {
                "ordinal_error": float(np.mean(errs)),
                "whdr_0.03": float(np.mean(whdrs)),
            }
            log.info("zero-shot %s: %s", ds.name, out[ds.name])
        return out

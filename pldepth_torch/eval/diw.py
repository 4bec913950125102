"""DIW human-pair WHDR: the zero-shot metric for Depth in the Wild
(``pldepth_tpu/eval/diw.py``).

WHDR over human ordinal labels = fraction of annotated point-pairs whose
predicted depth ordering disagrees with the human label (Chen et al. 2016
eq. 1 with their one-pair-per-image test protocol). The model predicts the
HR-WSI *descending* relative-depth convention -- a larger output means
CLOSER (reference pl_hourglass.py:22-31) -- while DIW's ``rel`` says which
point has greater *metric* depth (farther), so the predicted relation for
"A farther than B" is ``pred[A] < pred[B]``.

Pair coordinates are annotated in original-image pixels; images are
resized to the model's square input, so coordinates scale by
(target/orig_h, target/orig_w), rounded half to even (``np.round``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from pldepth_torch.data import io as dio
from pldepth_torch.data.diw import DIWItem
from pldepth_torch.train.trainer import pad_to_batch


def _scaled_pairs(pairs: np.ndarray, orig_hw, target: int) -> np.ndarray:
    h, w = orig_hw
    out = pairs.copy()
    out[:, [0, 2]] = np.clip(np.round(pairs[:, [0, 2]] * (target / h)), 0, target - 1)
    out[:, [1, 3]] = np.clip(np.round(pairs[:, [1, 3]] * (target / w)), 0, target - 1)
    return out


def evaluate_diw(trainer, state, items: List[DIWItem], input_size: int, batch_size: int = 8,
                 tau: float = 0.0) -> Dict[str, float]:
    """Batched zero-shot DIW evaluation -> {"diw_whdr", "n_pairs", ...}.

    ``tau``: ordinal equality margin on the *predicted* values -- with
    DIW's strict two-class labels the standard protocol is tau=0 (any
    predicted tie counts as a disagreement, matching the reference's
    ordinal-error treatment of ties, metrics.py:60-70).
    """
    predict = trainer.jit_predict()
    disagree = 0
    ties = 0
    total = 0
    for start in range(0, len(items), batch_size):
        chunk = items[start: start + batch_size]
        imgs, metas = [], []
        for it in chunk:
            raw = dio.read_image(it.image_path, 3)
            imgs.append(dio.resize_bilinear(raw, (input_size, input_size)))
            metas.append((it.pairs, raw.shape[:2]))
        preds = np.asarray(predict(state, pad_to_batch(np.stack(imgs), batch_size)))
        for j, (pairs, orig_hw) in enumerate(metas):
            p = np.squeeze(preds[j])
            sp = _scaled_pairs(pairs, orig_hw, input_size)
            za = p[sp[:, 0].astype(int), sp[:, 1].astype(int)]
            zb = p[sp[:, 2].astype(int), sp[:, 3].astype(int)]
            # model convention: larger output = closer = SMALLER depth, so
            # "A farther" (rel=+1) predicts za < zb
            pred_rel = np.where(
                np.abs(za - zb) <= tau * np.maximum(np.abs(za), np.abs(zb)),
                0.0,
                np.where(za < zb, 1.0, -1.0),
            )
            disagree += int((pred_rel != pairs[:, 4]).sum())
            ties += int((pred_rel == 0).sum())
            total += len(pairs)
    return {
        "diw_whdr": disagree / max(total, 1),
        "n_pairs": total,
        "n_images": len(items),
        "n_predicted_ties": ties,
    }

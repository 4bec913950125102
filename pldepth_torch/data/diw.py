"""DIW (Depth in the Wild, Chen et al. NeurIPS 2016) zero-shot loader
(``pldepth_tpu/data/diw.py``, copied: numpy and the standard library only).

BASELINE.json config #4 names "DIW/TUM/Sintel" for the zero-shot ordinal
suite and the CVPR paper's zero-shot story is DIW-centric, but the reference
ships no DIW DAO (its dao/ dispatcher stops at HR-WSI/Ibims/Sintel/DIODE/TUM,
pldepth/data/dao/dao_meta.py:9-22) — this is a capability the reference
*names* but never implemented. DIW supervision is one human-labeled ordinal
point-pair per image (no dense gt), so it gets its own loader + pair-WHDR
evaluator (eval/diw.py) instead of the dense DepthDataset contract.

On-disk layout (the official DIW release):

    <root>/DIW_test.csv          (or any single *.csv under root)
    <root>/<relative image paths as listed in the csv>

CSV format (official DIW annotation toolkit): two lines per sample —

    <image path>
    y_A,x_A,y_B,x_B,<rel>[,w,h]

coordinates are 1-indexed pixel positions (MATLAB heritage; converted to
0-indexed here), and ``rel`` is ``>`` meaning point A has GREATER metric
depth than B (A is farther) or ``<`` (A closer). Some dumps append the
image width/height — used, when present, to sanity-check coordinate
scaling. This convention is documented here because the reference has no
implementation to compare against; the fixture test
(tests/test_diw.py) is the executable spec; tests/test_torch_zeroshot.py holds
this copy to it.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class DIWItem:
    """One DIW sample: an image path + (N, 5) ordinal pair annotations
    ``[y_a, x_a, y_b, x_b, rel]`` in 0-indexed original-image pixel
    coordinates; ``rel`` = +1 if z_a > z_b (A farther), -1 if A closer."""

    image_path: str
    pairs: np.ndarray  # (N, 5) float32
    orig_size: Optional[tuple] = None  # (w, h) when the csv carries it


def _parse_csv(path: str, root: str) -> List[DIWItem]:
    items: List[DIWItem] = []
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    i = 0
    by_image = {}
    while i < len(lines):
        img_rel = lines[i]
        i += 1
        pairs = []
        size = None
        # one or more annotation lines may follow an image line
        while i < len(lines) and ("," in lines[i]) and (
            lines[i].split(",")[0].strip().lstrip("-").isdigit()
        ):
            f_ = [t.strip() for t in lines[i].split(",")]
            ya, xa, yb, xb = (float(v) - 1.0 for v in f_[:4])  # 1- -> 0-indexed
            rel = {">": 1.0, "<": -1.0}[f_[4]]
            pairs.append([ya, xa, yb, xb, rel])
            if len(f_) >= 7:
                size = (int(f_[5]), int(f_[6]))
            i += 1
        if not pairs:
            continue
        img_path = os.path.join(root, img_rel.lstrip("/\\"))
        if img_path in by_image:
            by_image[img_path].pairs = np.concatenate(
                [by_image[img_path].pairs,
                 np.asarray(pairs, np.float32)], axis=0
            )
        else:
            it = DIWItem(img_path, np.asarray(pairs, np.float32), size)
            by_image[img_path] = it
            items.append(it)
    return items


def load_diw(root: str, csv_path: Optional[str] = None) -> List[DIWItem]:
    """Parse the DIW annotation csv under ``root``; missing image files are
    dropped with a count (partial downloads are the DIW norm — the official
    set is fetched image-by-image from the web)."""
    if csv_path is None:
        cands = sorted(glob.glob(os.path.join(root, "*.csv")))
        preferred = [c for c in cands if "test" in os.path.basename(c).lower()]
        cands = preferred or cands
        if not cands:
            raise FileNotFoundError(f"no DIW annotation csv under {root}")
        csv_path = cands[0]
    items = _parse_csv(csv_path, root)
    present = [it for it in items if os.path.exists(it.image_path)]
    if len(present) < len(items):
        import logging

        logging.getLogger(__name__).warning(
            "DIW: %d/%d annotated images missing on disk (skipped)",
            len(items) - len(present), len(items),
        )
    if not present:
        raise FileNotFoundError(
            f"DIW csv {csv_path} lists no image present under {root}"
        )
    return present

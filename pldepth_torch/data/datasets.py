"""Datasets (``pldepth_tpu/data/datasets.py``): HR-WSI training data and
the synthetic set. Every dataset yields ``{"image": (H, W, 3) f32 [0,1],
"gt": (H, W), "mask": (H, W)}`` at a fixed target size. The zero-shot
evaluation sets come with the eval slice (ROADMAP.md queue 1 item 8), the
structured ``scenes`` set with the data path (item 7).

The synthetic fields use the JAX package's numpy streams; the port resizes
on TF's bilinear grid where the JAX package uses cv2 (data/io.py), so the
values agree to ~1e-4, not bitwise.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from pldepth_torch.data import io as dio


@dataclasses.dataclass
class DepthDataset:
    """An indexable dataset of fixed-shape depth samples."""

    name: str
    size: int
    loader: Callable[[int], Dict[str, np.ndarray]]
    asc_depth_order: bool = False  # True: lower gt = closer

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return self.loader(i)

    def take(self, n: int) -> "DepthDataset":
        return dataclasses.replace(self, size=min(n, self.size))

    def skip(self, n: int) -> "DepthDataset":
        n = min(n, self.size)
        return dataclasses.replace(self, size=self.size - n, loader=lambda i: self.loader(i + n))

    def cached(self) -> "DepthDataset":
        """The same samples, decoded once and kept in host memory."""
        items = [self.loader(i) for i in range(self.size)]
        return dataclasses.replace(self, loader=items.__getitem__)


def _smooth_field(rng: np.random.Generator, hw: Tuple[int, int]) -> np.ndarray:
    """Low-frequency random field in (0.05, 1.0) -- a plausible inverse depth."""
    coarse = rng.normal(size=(8, 8)).astype(np.float32)
    field = dio.resize_bilinear(coarse[..., None], hw)[..., 0]
    field = (field - field.min()) / max(float(np.ptp(field)), 1e-6)
    return 0.05 + 0.95 * field


def SyntheticDepthDataset(n: int = 64, image_size: int = 224, seed: int = 0,
                          mask_frac: float = 0.9) -> DepthDataset:
    def load(i: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(seed * 100_003 + i)
        hw = (image_size, image_size)
        gt = _smooth_field(rng, hw)
        image = np.stack([gt, _smooth_field(rng, hw),
                          rng.uniform(0, 1, hw).astype(np.float32)], axis=-1)
        mask = (rng.uniform(size=hw) < mask_frac).astype(np.float32)
        mask[0, 0] = 1.0
        return {"image": image, "gt": gt, "mask": mask}

    return DepthDataset(name="synthetic", size=n, loader=load)


def load_hrwsi(root: str, split: str = "train", target_size: int = 224,
               size: Optional[int] = None, shuffle: bool = False, seed: int = 0) -> DepthDataset:
    """HR-WSI layout (reference hr_wsi.py:55-63): ``{split}/imgs/*.jpg`` with
    ``gts/*.png`` and ``valid_masks/*.png`` by path substitution; images and
    gts bilinear-resized, masks nearest-resized."""
    files = sorted(glob.glob(os.path.join(root, split, "imgs", "*.jpg")))
    if not files:
        raise FileNotFoundError(f"no HR-WSI images under {root}/{split}/imgs")
    if shuffle:
        np.random.default_rng(seed).shuffle(files)
    if size:
        files = files[:size]

    def load(i: int) -> Dict[str, np.ndarray]:
        img_path = files[i]
        sub = lambda d: img_path.replace(f"{os.sep}imgs{os.sep}", f"{os.sep}{d}{os.sep}").replace(".jpg", ".png")  # noqa: E731
        ts = (target_size, target_size)
        image = dio.resize_bilinear(dio.read_image(img_path, 3), ts)
        gt = dio.resize_bilinear(dio.read_image(sub("gts"), 1), ts)[..., 0]
        mask = dio.resize_nearest(dio.read_image(sub("valid_masks"), 1)[..., 0], ts)
        return {"image": image, "gt": gt, "mask": mask}

    return DepthDataset(name="hrwsi", size=len(files), loader=load)


def _synthetic(root="", target_size=224, size=None, split="train", seed=0, shuffle=False):
    return SyntheticDepthDataset(size or 64, target_size, seed)


DATASETS: Dict[str, Callable[..., DepthDataset]] = {
    "synthetic": _synthetic,
    "HR-WSI": load_hrwsi,
}
_LATER = {"scenes": "item 7", "ibims": "item 8", "tum": "item 8", "diode": "item 8",
          "sintel": "item 8"}


def get_dataset(name: str, **kwargs) -> DepthDataset:
    """Name lookup, case-insensitive like the reference (io_utils.py:13-25)."""
    canonical = {k.lower(): k for k in DATASETS}
    key = canonical.get(name.lower().replace("_", "-")) or canonical.get(name.lower())
    if key is None:
        if name.lower() in _LATER:
            raise NotImplementedError(
                f"dataset {name!r} is not ported yet: ROADMAP.md queue 1 {_LATER[name.lower()]}")
        raise ValueError(f"Unknown dataset name: {name} (have {sorted(DATASETS)})")
    return DATASETS[key](**kwargs)

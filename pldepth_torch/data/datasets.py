"""Datasets (``pldepth_tpu/data/datasets.py``): HR-WSI training data, the
zero-shot evaluation sets and the synthetic set. Every dataset yields
``{"image": (H, W, 3) f32 [0,1], "gt": (H, W), "mask": (H, W)}`` at a fixed
target size. The structured ``scenes`` set is ``data/scenes.py``.

Ibims/DIODE/Sintel/TUM are test-only (mask = all ones) and carry
``asc_depth_order=True`` -- lower values are closer (reference
pl_hourglass.py:22-31; Sintel depth_viz PNGs are scaled x255, sintel.py:31).
Their loaders take no ``size`` or ``seed``, as in the JAX package, so
``cli train --dataset IBIMS`` fails with TypeError in both.

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


def _eval_ds(name, items, target_size, read_fn, asc=True, gt_scale=1.0):
    def load(i):
        image, gt = read_fn(items[i])
        ts = (target_size, target_size)
        image = dio.resize_bilinear(np.atleast_3d(image), ts)
        if image.shape[-1] == 1:
            image = np.repeat(image, 3, axis=-1)
        gt = dio.resize_bilinear(np.asarray(gt, np.float32)[..., None], ts)[..., 0]
        return {"image": image, "gt": gt * gt_scale, "mask": np.ones(ts, np.float32)}

    return DepthDataset(name=name, size=len(items), loader=load, asc_depth_order=asc)


def load_ibims(root: str, target_size: int = 224) -> DepthDataset:
    items = sorted(glob.glob(os.path.join(root, "*.mat")))
    return _eval_ds("ibims", items, target_size, dio.read_mat_ibims)


def load_tum(root: str, target_size: int = 224) -> DepthDataset:
    items = sorted(glob.glob(os.path.join(root, "*.h5")))
    return _eval_ds("tum", items, target_size, dio.read_h5_tum)


def load_diode(root: str, target_size: int = 224) -> DepthDataset:
    imgs = sorted(glob.glob(os.path.join(root, "*", "*", "*", "*.png")))

    def read(img_path):
        return (dio.read_image(img_path, 3),
                dio.read_npy_depth(img_path.replace(".png", "_depth.npy")))

    return _eval_ds("diode", imgs, target_size, read)


def load_sintel(root: str, target_size: int = 224) -> DepthDataset:
    imgs = sorted(glob.glob(os.path.join(root, "images", "*", "*.png")))

    def read(img_path):
        gt_path = img_path.replace(f"{os.sep}images{os.sep}", f"{os.sep}depth_viz{os.sep}")
        # depth_viz PNGs store scaled depth; x255 restores it (sintel.py:31)
        return dio.read_image(img_path, 3), dio.read_image(gt_path, 1)[..., 0] * 255.0

    return _eval_ds("sintel", imgs, target_size, read)


def _synthetic(root="", target_size=224, size=None, split="train", seed=0, shuffle=False):
    return SyntheticDepthDataset(size or 64, target_size, seed)


def _load_scenes(root="", target_size=224, size=None, split="train", seed=0, shuffle=False):
    from pldepth_torch.data.scenes import SceneDepthDataset

    # distinct index streams per split so train/val scenes never coincide
    return SceneDepthDataset(size or 64, target_size, seed + (1_000 if split != "train" else 0))


DATASETS: Dict[str, Callable[..., DepthDataset]] = {
    "synthetic": _synthetic,
    "scenes": _load_scenes,
    "HR-WSI": load_hrwsi,
    "IBIMS": load_ibims,
    "TUM": load_tum,
    "DIODE": load_diode,
    "SINTEL": load_sintel,
}


def get_dataset(name: str, **kwargs) -> DepthDataset:
    """Name lookup, case-insensitive like the reference (io_utils.py:13-25)."""
    canonical = {k.lower(): k for k in DATASETS}
    key = canonical.get(name.lower().replace("_", "-")) or canonical.get(name.lower())
    if key is None:
        raise ValueError(f"Unknown dataset name: {name} (have {sorted(DATASETS)})")
    return DATASETS[key](**kwargs)

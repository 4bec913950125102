"""Host-side decode and resize (``pldepth_tpu/data/io.py``): jpg/png
(HR-WSI, Sintel), .npy depth (DIODE), .mat (Ibims) and .h5 (TUM).

PIL, scipy and h5py are imported inside the reader that needs them, so the
rest of the port imports on a host without them. The host resize runs
``F.interpolate`` on the CPU on TF's half-pixel grid (1.2e-7 from ``jax.image.resize``); the JAX
package uses cv2 ``INTER_LINEAR``, the same grid with fixed-point
coefficients. Measured gap between the two on [0,1] float32 images resized
to 448x448: 5.8e-5 from 480x640, 1.4e-4 from 1080x1920, against an 8-bit
step of 3.9e-3 (tests/test_torch_resize.py holds it at 2e-4).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from pldepth_torch.ops.resize import resize_bilinear as _resize_nhwc


def read_image(path: str, num_channels: int = 3) -> np.ndarray:
    """Decode jpg/png to float32 [0,1], shape (H, W, C)."""
    from PIL import Image

    img = Image.open(path)
    if num_channels == 3:
        img = img.convert("RGB")
    elif num_channels == 1 and img.mode not in ("L", "I", "I;16"):
        img = img.convert("L")
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.dtype == np.uint16 or img.mode in ("I", "I;16"):
        # 16-bit grayscale PNGs decode as mode "I"
        return arr.astype(np.float32) / 65535.0
    return arr.astype(np.float32) / 255.0


def resize_bilinear(arr: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """(H, W[, C]) -> (size[0], size[1][, C]), TF-convention bilinear."""
    a = np.asarray(arr, np.float32)
    squeeze = a.ndim == 2
    t = torch.from_numpy(np.ascontiguousarray(a[..., None] if squeeze else a))
    out = _resize_nhwc(t, size).numpy()
    return out[..., 0] if squeeze else out


def resize_nearest(arr: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """(H, W) -> size, nearest neighbour at ``floor(i * src / dst)`` (cv2
    ``INTER_NEAREST``'s index rule, which the JAX package uses)."""
    h, w = int(size[0]), int(size[1])
    idx0 = np.minimum((np.arange(h) * (arr.shape[0] / h)).astype(int), arr.shape[0] - 1)
    idx1 = np.minimum((np.arange(w) * (arr.shape[1] / w)).astype(int), arr.shape[1] - 1)
    return np.asarray(arr)[np.ix_(idx0, idx1)].astype(np.float32)


def read_npy_depth(path: str) -> np.ndarray:
    return np.squeeze(np.load(path)).astype(np.float32)


def read_mat_ibims(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Ibims .mat: data struct with image at field 2, depth at field 3
    (reference ibims.py:19-22)."""
    from scipy import io as sio

    raw = sio.loadmat(path)["data"]
    image = np.asarray(raw[0][0][2], np.float32)
    gt = np.asarray(raw[0][0][3], np.float32)
    if image.max() > 1.5:
        image = image / 255.0
    return image, gt


def read_h5_tum(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """TUM .h5: gt/img_1 image + gt/pp_depth pseudo-depth
    (reference tum.py:27-31)."""
    import h5py

    with h5py.File(path, "r") as f:
        image = np.asarray(f["gt"]["img_1"], np.float32)
        gt = np.asarray(f["gt"]["pp_depth"], np.float32)
    if image.max() > 1.5:
        image = image / 255.0
    return image, gt

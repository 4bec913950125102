"""Resizing with TF2 / ``jax.image.resize`` semantics, NHWC at the interface.

The JAX package resizes with ``jax.image.resize(method='bilinear',
antialias=False)`` (``pldepth_tpu/ops/resize.py``): half-pixel centres and
edge clamping, the grid of ``tf.image.resize`` and Keras
``UpSampling2D(interpolation='bilinear')``. ``F.interpolate`` with
``align_corners=False, antialias=False`` samples the same grid
(tests/test_torch_resize.py holds it against tests/golden/tf_resize.npz).
``jax.image.resize(..., "nearest")`` samples source pixel
``floor((i + 0.5) * in / out)``: ``F.interpolate``'s ``"nearest-exact"``,
not its ``"nearest"`` (``floor(i * in / out)``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def resize_bilinear(img: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C) to (..., size[0], size[1], C)."""
    lead = img.shape[:-3]
    h, w, c = img.shape[-3:]
    x = img.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(int(size[0]), int(size[1])), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, int(size[0]), int(size[1]), c)


def resize_nearest(img: torch.Tensor, size: Sequence[int],
                   channel_last: bool = True) -> torch.Tensor:
    """Nearest-neighbor resize (masks; reference hr_wsi.py:73-74).

    2-D inputs are (H, W). Higher ranks are (..., H, W, C) by default; a
    batched channel-less mask stack (B, H, W) must pass
    ``channel_last=False`` -- silently treating it as (H, W, C) would
    resample the batch axis and leave W untouched."""
    out_hw = (int(size[0]), int(size[1]))
    if img.dim() == 2 or not channel_last:
        lead, (h, w) = img.shape[:-2], img.shape[-2:]
        y = F.interpolate(img.reshape(-1, 1, h, w), size=out_hw, mode="nearest-exact")
        return y.reshape(*lead, *out_hw)
    lead = img.shape[:-3]
    h, w, c = img.shape[-3:]
    x = img.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=out_hw, mode="nearest-exact")
    return y.permute(0, 2, 3, 1).reshape(*lead, *out_hw, c)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """Keras UpSampling2D(interpolation='bilinear') equivalent, NHWC."""
    n, h, w, c = x.shape
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(2 * h, 2 * w),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)

"""TF/lax SAME convolution on NHWC tensors.

``padding="SAME"`` in lax pads ``max((out-1)*stride + k - size, 0)`` in
total with the smaller half before: asymmetric at stride 2 on even sizes,
so ``padding=k//2`` would be wrong there. A conv built with an explicit
``padding`` (the ResNet stem's ``((3, 3), (3, 3))``) pads that much on
every side instead.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def same_out_and_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """SAME output size ``ceil(size/stride)`` and the pad before it."""
    out = -(-size // stride)
    return out, max((out - 1) * stride + k - size, 0) // 2


def same_pads(h: int, w: int, k: int, stride: int) -> Tuple[int, int, int, int]:
    """(left, right, top, bottom) SAME pads of an (h, w) image."""
    ho, pt = same_out_and_pad(h, k, stride)
    wo, pl = same_out_and_pad(w, k, stride)
    pb = max((ho - 1) * stride + k - h, 0) - pt
    pr = max((wo - 1) * stride + k - w, 0) - pl
    return pl, pr, pt, pb


def conv_pads(h: int, w: int, k: int, stride: int,
              padding: Optional[int] = None) -> Tuple[int, int, int, int]:
    """(left, right, top, bottom) pads: SAME's where ``padding`` is None,
    else ``padding`` on every side."""
    if padding is None:
        return same_pads(h, w, k, stride)
    return (padding,) * 4


def conv2d_same_nhwc(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
                     groups: int = 1, padding: Optional[int] = None) -> torch.Tensor:
    """SAME (or explicitly padded) convolution of NHWC ``x`` with an OIHW
    ``weight`` of x's dtype."""
    pads = conv_pads(x.shape[1], x.shape[2], weight.shape[-1], stride, padding)
    if any(pads):
        x = F.pad(x, (0, 0, *pads))
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, None, stride, 0, 1, groups)
    return y.permute(0, 2, 3, 1)

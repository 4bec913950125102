"""Fused decoder tail: 2x bilinear upsample + 3x3 head conv as ONE
half-resolution convolution with 4 phase outputs, then depth-to-space.

Port of ``pldepth_tpu/ops/fused_tail.py``. With TF half-pixel 2x
upsampling, ``u(2i) = 0.25 x[i-1] + 0.75 x[i]`` and ``u(2i+1) = 0.75 x[i] +
0.25 x[i+1]``, so a 3x3 tap window around output row ``2i+di`` reads only
input rows ``i-1..i+1``; folding those row/col mixing matrices into the head
kernel gives a composed (4F, C, 3, 3) kernel. Edge clamping of the upsample
and zero padding of the head conv only reach the outermost two output
rows/cols, which are patched with the exact two-step tail on 2-pixel input
strips. Plain PyTorch convolutions: this is not a kernel of the TPU package.

Weights here are OIHW (``F.conv2d``'s layout): ``w`` is (F, C, 3, 3).
"""

from __future__ import annotations

import numpy as np
import torch

from pldepth_torch.ops.conv import conv2d_same_nhwc
from pldepth_torch.ops.resize import upsample2x_bilinear

# Row-mixing matrices A[di][conv_tap, input_offset]
_A = np.array(
    [
        [[0.75, 0.25, 0.0], [0.25, 0.75, 0.0], [0.0, 0.75, 0.25]],  # di = 0
        [[0.25, 0.75, 0.0], [0.0, 0.75, 0.25], [0.0, 0.25, 0.75]],  # di = 1
    ],
    dtype=np.float32,
)


def compose_upsample_conv_kernel(w: torch.Tensor) -> torch.Tensor:
    """Fold the bilinear-2x kernel into an OIHW (F, C, 3, 3) conv kernel.

    Returns the composed (4F, C, 3, 3) f32 kernel; output channel ``p*F + f``
    with ``p = 2*di + dj`` holds the (row-phase di, col-phase dj) output of
    feature ``f``, so a depth-to-space reshape recovers NHWC order.
    """
    a = torch.as_tensor(_A, device=w.device)
    w32 = w.to(torch.float32).permute(2, 3, 1, 0)  # HWIO (3, 3, C, F)
    # K[di,dj,t,u,c,f] = sum_{a,b} w[a,b,c,f] A[di][a,t] A[dj][b,u]
    k = torch.einsum("abcf,dat,ebu->detucf", w32, a, a)
    c, f = w32.shape[2], w32.shape[3]
    k = k.reshape(4, 3, 3, c, f).permute(1, 2, 3, 0, 4).reshape(3, 3, c, 4 * f)
    return k.permute(3, 2, 0, 1).contiguous()  # OIHW (4F, C, 3, 3)


def _exact_tail(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Reference two-step tail (upsample then conv), without bias."""
    return conv2d_same_nhwc(upsample2x_bilinear(x).contiguous(), w)


def fused_upsample2x_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``conv3x3(upsample2x_bilinear(x), w) + b`` without materialising the
    upsampled tensor. x: (B, H, W, C) NHWC; w: (F, C, 3, 3); b: (F,).
    Returns (B, 2H, 2W, F) in x.dtype (bias added in x.dtype)."""
    n, h, wd, c = x.shape
    f = w.shape[0]
    wx = w.to(x.dtype)
    if h < 3 or wd < 3:  # degenerate sizes: the exact path
        return _exact_tail(x, wx) + b.to(x.dtype)

    kc = compose_upsample_conv_kernel(w).to(x.dtype)
    ph = conv2d_same_nhwc(x, kc)  # (B, H, W, 4F)
    out = ph.reshape(n, h, wd, 2, 2, f).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(n, 2 * h, 2 * wd, f)

    # border patch: exact tail on 2-pixel strips (upsampling a 2-row slice
    # reproduces the full image's clamped u(0..2) rows exactly)
    left = _exact_tail(x[:, :, :2, :], wx)[:, :, :2, :]
    right = _exact_tail(x[:, :, -2:, :], wx)[:, :, -2:, :]
    out = torch.cat([left, out[:, :, 2:-2, :], right], dim=2)
    top = _exact_tail(x[:, :2, :, :], wx)[:, :2, :, :]
    bottom = _exact_tail(x[:, -2:, :, :], wx)[:, -2:, :, :]
    out = torch.cat([top, out[:, 2:-2, :, :], bottom], dim=1)
    return out + b.to(x.dtype)


def fused_upsample2x_head(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depth-head (F=1) alias of :func:`fused_upsample2x_conv`."""
    return fused_upsample2x_conv(x, w, b)

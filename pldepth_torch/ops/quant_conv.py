"""Dense int8 convolution as im2col + K4 (ops/quant_matmul.py).

Eager PyTorch has no int8 convolution on CUDA, so every dense int8 conv
site of the serving graph is an int8 matrix product: TF SAME padding with
zeros (exact in the int8 domain, since the zero-point is 0; asymmetric at
stride 2, ops/conv.py) or an explicit pad on every side (the ResNet stem),
then ``kh * kw`` strided slices concatenated along
channels into the (M, kh * kw * Cin) patch matrix. Its columns run (row of
the window, column of the window, input channel), the order of a flax HWIO
``kernel_q.reshape(kh * kw * Cin, Cout)``. A 1x1 site is a reshape, of
every second row and column at stride 2 (ResNet's downsampling 1x1s). At
448^2, batch 8, the largest patch matrix is ff_effnet's decoder ``conv3``:
100352 x 2592 int8, 260 MB; an implicit-GEMM K4 that reads the windows in
place is later work.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from pldepth_torch.ops.conv import conv_pads
from pldepth_torch.ops.quant_matmul import quant_matmul


def _out_hw(h: int, w: int, k: int, stride: int,
            padding: Optional[int]) -> Tuple[int, int, Tuple[int, int, int, int]]:
    pads = conv_pads(h, w, k, stride, padding)
    pl, pr, pt, pb = pads
    return (h + pt + pb - k) // stride + 1, (w + pl + pr - k) // stride + 1, pads


def im2col_same(q: torch.Tensor, k: int, stride: int,
                padding: Optional[int] = None) -> torch.Tensor:
    """(B, H, W, C) int8 -> (B * Ho * Wo, k * k * C) patch matrix of a k x k
    window, padded SAME or by ``padding`` on every side."""
    b, h, w, c = q.shape
    ho, wo, pads = _out_hw(h, w, k, stride, padding)
    if k == 1 and not any(pads):
        # a 1x1 window is a reshape, of the strided rows and columns at stride 2
        qs = q if stride == 1 else q[:, ::stride, ::stride]
        return qs.reshape(b * ho * wo, c)
    pl, pr, pt, pb = pads
    qp = F.pad(q, (0, 0, pl, pr, pt, pb)) if any(pads) else q
    cols = [qp[:, i: i + stride * (ho - 1) + 1: stride, j: j + stride * (wo - 1) + 1: stride, :]
            for i in range(k) for j in range(k)]
    return torch.cat(cols, dim=-1).reshape(b * ho * wo, k * k * c)


def quant_conv2d(q: torch.Tensor, kernel_q: torch.Tensor, w_scale: torch.Tensor,
                 bias: torch.Tensor, a_scale, stride: int = 1,
                 out_dtype: torch.dtype = torch.bfloat16,
                 padding: Optional[int] = None) -> torch.Tensor:
    """SAME (or ``padding`` on every side) int8 conv of NHWC ``q`` with a
    square HWIO int8 ``kernel_q`` on K4: ``conv(q, kernel_q) * (a_scale *
    w_scale) + bias`` as ``out_dtype``, (B, Ho, Wo, Cout)."""
    kh, kw, cin, cout = kernel_q.shape
    if kh != kw:
        raise ValueError(f"square windows only, got {kh}x{kw}")
    b, h, w, _ = q.shape
    ho, wo, _ = _out_hw(h, w, kh, stride, padding)
    cols = im2col_same(q, kh, stride, padding).contiguous()
    y = quant_matmul(cols, kernel_q.reshape(kh * kw * cin, cout).contiguous(), w_scale, bias,
                     a_scale, out_dtype=out_dtype)
    return y.reshape(b, ho, wo, cout)

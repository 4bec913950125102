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

Row-sharded (``rows``, ops/halo.py): a rank reads one row of each
neighbour, runs the phase conv on its rows, patches its outermost two
columns with the exact tail of its rows, and patches a top or bottom pair
of rows only where its rows touch the image's border.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from pldepth_torch.core.device import Constants, wide
from pldepth_torch.ops.halo import HaloPlan, RowShard, extend_rows
from pldepth_torch.ops.resize import upsample2x_bilinear, upsample_row_plan

# Row-mixing matrices A[di][conv_tap, input_offset]
_A = np.array(
    [
        [[0.75, 0.25, 0.0], [0.25, 0.75, 0.0], [0.0, 0.75, 0.25]],  # di = 0
        [[0.25, 0.75, 0.0], [0.0, 0.75, 0.25], [0.0, 0.25, 0.75]],  # di = 1
    ],
    dtype=np.float32,
)
_A_ON = Constants(_A)


def compose_upsample_conv_kernel(w: torch.Tensor) -> torch.Tensor:
    """Fold the bilinear-2x kernel into an OIHW (F, C, 3, 3) conv kernel.

    Returns the composed (4F, C, 3, 3) f32 kernel (float64 for a float64
    ``w``); output channel ``p*F + f`` with ``p = 2*di + dj`` holds the
    (row-phase di, col-phase dj) output of feature ``f``, so a
    depth-to-space reshape recovers NHWC order.
    """
    w32 = wide(w).permute(2, 3, 1, 0)  # HWIO (3, 3, C, F)
    a = _A_ON.like(w32)
    # K[di,dj,t,u,c,f] = sum_{a,b} w[a,b,c,f] A[di][a,t] A[dj][b,u]
    k = torch.einsum("abcf,dat,ebu->detucf", w32, a, a)
    c, f = w32.shape[2], w32.shape[3]
    k = k.reshape(4, 3, 3, c, f).permute(1, 2, 3, 0, 4).reshape(3, 3, c, 4 * f)
    return k.permute(3, 2, 0, 1).contiguous()  # OIHW (4F, C, 3, 3)


def _exact_tail(x: torch.Tensor, w: torch.Tensor, top: bool = True,
                bottom: bool = True) -> torch.Tensor:
    """Reference two-step tail (upsample then conv), without bias. ``x``
    holds rows ``[a - 1, b + 1)`` of the image, without the row above where
    ``top`` (its rows start at the image's top) and without the row below
    where ``bottom``; the result is output rows ``[2a, 2b)``: the upsampled
    rows ``[2a - 1, 2b + 1)`` (zero rows past the image), convolved with no
    row padding."""
    t, u = int(not top), int(not bottom)
    up = upsample2x_bilinear(x)
    up = up.narrow(1, t, up.shape[1] - t - u)
    up = F.pad(up, (0, 0, 1, 1, 1 - t, 1 - u))
    return F.conv2d(up.permute(0, 3, 1, 2), w).permute(0, 2, 3, 1)


def _fused_tail(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, h: int, top: bool,
                bottom: bool) -> torch.Tensor:
    """The fused tail of ``x``'s rows (:func:`_exact_tail`'s layout) of an
    image of ``h`` rows: the phase conv, the outermost two columns patched
    with the exact tail, and the top / bottom two rows where the rows touch
    the image's top / bottom (upsampling a 2-row slice reproduces the whole
    image's clamped u(0..2) rows exactly)."""
    wx = w.to(x.dtype)
    n, wd, f = x.shape[0], x.shape[2], w.shape[0]
    if h < 3 or wd < 3:  # degenerate sizes: the exact path
        return _exact_tail(x, wx, top, bottom) + b.to(x.dtype)
    rows = x.shape[1] - (not top) - (not bottom)
    kc = compose_upsample_conv_kernel(w).to(x.dtype)
    xp = F.pad(x, (0, 0, 1, 1, int(top), int(bottom)))
    ph = F.conv2d(xp.permute(0, 3, 1, 2), kc).permute(0, 2, 3, 1)  # (B, rows, W, 4F)
    out = ph.reshape(n, rows, wd, 2, 2, f).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(n, 2 * rows, 2 * wd, f)
    left = _exact_tail(x[:, :, :2, :], wx, top, bottom)[:, :, :2, :]
    right = _exact_tail(x[:, :, -2:, :], wx, top, bottom)[:, :, -2:, :]
    out = torch.cat([left, out[:, :, 2:-2, :], right], dim=2)
    pieces = [out]
    if top:
        pieces = [_exact_tail(x[:, :2, :, :], wx)[:, :2, :, :], out[:, 2:]]
    if bottom:
        pieces[-1] = pieces[-1][:, :pieces[-1].shape[1] - 2]
        pieces.append(_exact_tail(x[:, -2:, :, :], wx)[:, -2:, :, :])
    return torch.cat(pieces, dim=1) + b.to(x.dtype)


def fused_upsample2x_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          rows: Optional[RowShard] = None) -> torch.Tensor:
    """``conv3x3(upsample2x_bilinear(x), w) + b`` without materialising the
    upsampled tensor. x: (B, H, W, C) NHWC; w: (F, C, 3, 3); b: (F,).
    Returns (B, 2H, 2W, F) in x.dtype (bias added in x.dtype). With
    ``rows`` (x's level), ``x`` is this rank's rows and the result its rows
    of the level above."""
    if rows is None:
        return _fused_tail(x, w, b, x.shape[1], True, True)
    plan = upsample_row_plan(rows)
    return fused_tail_rows_local(extend_rows(x, rows, plan), w, b, plan, rows.index)


def fused_tail_rows_local(ext: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          plan: HaloPlan, q: int) -> torch.Tensor:
    """Rank ``q``'s rows of :func:`fused_upsample2x_conv` from ``ext``, its
    input rows ``[a - 1, b + 1)`` clipped to the image (``plan.need[q]``).
    A rank with no rows runs the exact tail on two zero rows and keeps
    none."""
    if plan.need[q] is None:
        z = ext.new_zeros((ext.shape[0], 2, *ext.shape[2:]))
        return (_exact_tail(torch.cat([ext, z], dim=1), w.to(ext.dtype))
                + b.to(ext.dtype)).narrow(1, 0, 0)
    return _fused_tail(ext, w, b, plan.height, plan.lo[q] < 0, plan.hi[q] > plan.height)


def fused_upsample2x_head(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          rows: Optional[RowShard] = None) -> torch.Tensor:
    """Depth-head (F=1) alias of :func:`fused_upsample2x_conv`."""
    return fused_upsample2x_conv(x, w, b, rows)

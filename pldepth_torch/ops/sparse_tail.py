"""Sparse decoder tail (``pldepth_tpu/ops/sparse_tail.py``): the
full-resolution head evaluated only at the ranked pixels.

The ranking loss reads the predicted map at ``rankings_per_image *
ranking_size`` pixels an image. With ``pixels`` the decoders
(models/decoders.py) keep everything through the last BatchNorm dense (at
<= 1/2 resolution, so batch statistics and their gradients are those of
the dense path) and replace the last ``upsample2x_bilinear`` + head conv
by a gather of the bilinear taps of each of the head's ``window x window``
taps (:func:`sparse_upsample2x_taps`), to which the same head parameters
apply.

The taps follow ops/resize.py's half-pixel rule with edge clamping
(output ``p`` samples input ``p / 2 - 0.25``); a tap outside the image is
zero, the head conv's SAME padding. Source indices are clamped into the
image, so the gather never reads outside it: a pixel outside the image
(a ranking index past the map) gets the head's value on zeros, as in the
JAX package, not NaN.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pldepth_torch.ops.listmle_kernel import ranking_index


def _bilinear2x_taps_1d(p: torch.Tensor, size_in: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(i0, i1, frac) of output coordinates ``p`` (int, may lie outside)
    along one axis: the two clamped source indices and the weight of
    ``i1`` (``i0`` weighs ``1 - frac``)."""
    t = p.to(torch.float32) / 2.0 - 0.25
    lo = torch.floor(t)
    frac = t - lo
    lo = lo.to(torch.int64)
    return lo.clamp(0, size_in - 1), (lo + 1).clamp(0, size_in - 1), frac


def sparse_upsample2x_taps(x: torch.Tensor, pixels: torch.Tensor,
                           window: int = 3) -> torch.Tensor:
    """``window x window`` patches of ``upsample2x_bilinear(x)`` centred at
    full-resolution ``pixels``.

    x: (B, H2, W2, C) half-resolution map; pixels: (B, N, 2) int (row,
    col). Returns (B, N, window, window, C) in x's dtype, taps outside the
    (2 H2, 2 W2) image zero."""
    b, h2, w2, c = x.shape
    h, w = 2 * h2, 2 * w2
    n = pixels.shape[1]
    d = torch.arange(window, device=x.device, dtype=torch.int64) - window // 2
    pr = pixels[..., 0].to(torch.int64)[..., None] + d  # (B, N, win)
    pc = pixels[..., 1].to(torch.int64)[..., None] + d
    valid = (((pr >= 0) & (pr < h))[..., :, None]
             & ((pc >= 0) & (pc < w))[..., None, :])  # (B, N, win, win)
    i0r, i1r, fr = _bilinear2x_taps_1d(pr, h2)
    i0c, i1c, fc = _bilinear2x_taps_1d(pc, w2)
    xf = x.reshape(b, h2 * w2, c)

    def take(ir, ic):
        idx = (ir[..., :, None] * w2 + ic[..., None, :]).reshape(b, -1, 1)
        return torch.gather(xf, 1, idx.expand(-1, -1, c)).reshape(b, n, window, window, c)

    fr = fr[..., :, None, None].to(x.dtype)  # weight of i1r
    fc = fc[..., None, :, None].to(x.dtype)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    tap = ((one - fr) * ((one - fc) * take(i0r, i0c) + fc * take(i0r, i1c))
           + fr * ((one - fc) * take(i1r, i0c) + fc * take(i1r, i1c)))
    return tap * valid[..., None].to(x.dtype)


def pixels_of(rankings: torch.Tensor, width: int) -> torch.Tensor:
    """(B, RPI, K, 2) rankings -> (B, RPI * K, 2) int (row, col) of their
    flat indices ``rankings[..., 0]`` (truncated toward zero, NaN as 0, as
    the JAX step's int32 cast; ``flat // w, flat % w`` by floor division,
    so a negative index gives a negative row)."""
    b = rankings.shape[0]
    flat = ranking_index(rankings[..., 0]).reshape(b, -1)
    return torch.stack([torch.div(flat, width, rounding_mode="floor"),
                        torch.remainder(flat, width)], dim=-1)

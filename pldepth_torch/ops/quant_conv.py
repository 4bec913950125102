"""Dense int8 convolution on K4 (ops/quant_matmul.py).

Eager PyTorch has no int8 convolution on CUDA, so every dense int8 conv
site of the serving graph is an int8 matrix product whose K runs (row of
the window, column of the window, input channel), the order of a flax HWIO
``kernel_q.reshape(kh * kw * Cin, Cout)``.

On the card no patch matrix exists. A 1x1 stride-1 site is a reshape of the
NHWC activation into K4's (M, Cin) operand. Every other site (k > 1, or
stride 2: B0's and ResNet's 3x3s, the 7x7 stem, ResNet's downsampling
1x1s) goes to the kernel's window entry point, ``quant_conv2d`` of
``csrc/quant_matmul.cu``, which reads ``q[b, ho s + i - pt, wo s + j - pl,
c]`` in place and fills taps outside the image with zeros (a stem's 3
channels are first padded to 4, :func:`pack_kernel`). That is TF SAME
padding (asymmetric at stride 2, ops/conv.py) or an explicit pad on every
side (the ResNet stem), exact in the int8 domain since the zero-point is 0.

On the CPU the site is :func:`quant_conv2d_plain`: :func:`im2col_same`
writes the (M, kh * kw * Cin) patch matrix and K4's plain version
multiplies it. That is the kernel's plain twin; the card's route never
calls it (``im2col_same.calls`` counts, chip_smoke.py gates it at 0).
``quant_conv2d.window_launches`` counts the launches of the window entry
point (each also counts in ``quant_matmul.launches``).

Row-sharded (spatial sharding, ops/halo.py): :func:`quant_conv2d_rows_local`
convolves a rank's int8 rows extended by their halo (exchanged as int8) on
the window entry point, which reads the rows outside the image as zero
(exact: the zero-point is 0) through its row pad, and the whole image's
column pad; its plain twin is :func:`quant_conv2d_rows_local_plain`. A
rank with no output rows launches nothing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from pldepth_torch.ops import quant_matmul as k4
from pldepth_torch.ops.conv import conv_pads, row_pads
from pldepth_torch.ops.halo import HaloPlan


def _out_hw(h: int, w: int, k: int, stride: int,
            padding: Optional[int]) -> Tuple[int, int, Tuple[int, int, int, int]]:
    pads = conv_pads(h, w, k, stride, padding)
    pl, pr, pt, pb = pads
    return (h + pt + pb - k) // stride + 1, (w + pl + pr - k) // stride + 1, pads


def im2col_same(q: torch.Tensor, k: int, stride: int,
                padding: Optional[int] = None) -> torch.Tensor:
    """(B, H, W, C) int8 -> (B * Ho * Wo, k * k * C) patch matrix of a k x k
    window, padded SAME or by ``padding`` on every side."""
    im2col_same.calls += 1
    b, h, w, c = q.shape
    ho, wo, pads = _out_hw(h, w, k, stride, padding)
    if k == 1 and not any(pads):
        # a 1x1 window is a reshape, of the strided rows and columns at stride 2
        qs = q if stride == 1 else q[:, ::stride, ::stride]
        return qs.reshape(b * ho * wo, c)
    pl, pr, pt, pb = pads
    return _patches(F.pad(q, (0, 0, pl, pr, pt, pb)) if any(pads) else q, k, stride, ho, wo)


def _patches(qp: torch.Tensor, k: int, stride: int, ho: int, wo: int) -> torch.Tensor:
    """The (B * ho * wo, k * k * C) patch matrix of an already padded
    (B, H, W, C) ``qp``, read VALID."""
    b, c = qp.shape[0], qp.shape[3]
    cols = [qp[:, i: i + stride * (ho - 1) + 1: stride, j: j + stride * (wo - 1) + 1: stride, :]
            for i in range(k) for j in range(k)]
    return torch.cat(cols, dim=-1).reshape(b * ho * wo, k * k * c)


im2col_same.calls = 0
CIN_ALIGN = 4  # the window read's narrowest asynchronous request, in bytes


def pack_kernel(kernel_q: torch.Tensor) -> torch.Tensor:
    """``pack_weight`` of an HWIO ``kernel_q`` for the window read, its Cin
    zero-padded to a multiple of ``CIN_ALIGN`` (the stems' 3 channels become
    4, so that a tap's run is whole 4-byte requests; the zero channel adds
    nothing to the exact int32 sum)."""
    pad = -kernel_q.shape[2] % CIN_ALIGN
    return k4.pack_weight(F.pad(kernel_q, (0, 0, 0, pad)) if pad else kernel_q)


def _check(q: torch.Tensor, kernel_q: torch.Tensor) -> None:
    if q.dim() != 4 or kernel_q.dim() != 4:
        raise ValueError(f"quant_conv2d: q {tuple(q.shape)} and kernel_q "
                         f"{tuple(kernel_q.shape)} must be NHWC and HWIO")
    kh, kw, cin, _ = kernel_q.shape
    if kh != kw:
        raise ValueError(f"square windows only, got {kh}x{kw}")
    if q.shape[3] != cin:
        raise ValueError(f"quant_conv2d: q has {q.shape[3]} channels, kernel_q takes {cin}")


def quant_conv2d_plain(q: torch.Tensor, kernel_q: torch.Tensor, w_scale: torch.Tensor,
                       bias: torch.Tensor, a_scale, stride: int = 1,
                       out_dtype: torch.dtype = torch.bfloat16,
                       padding: Optional[int] = None, act: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch :func:`quant_conv2d` on either device: the patch matrix
    of :func:`im2col_same` through K4's plain version."""
    _check(q, kernel_q)
    kh, kw, cin, cout = kernel_q.shape
    b, h, w, _ = q.shape
    ho, wo, _ = _out_hw(h, w, kh, stride, padding)
    y = k4.quant_matmul_plain(im2col_same(q, kh, stride, padding),
                              kernel_q.reshape(kh * kw * cin, cout), w_scale, bias, a_scale,
                              act, out_dtype)
    return y.reshape(b, ho, wo, cout)


def quant_conv2d(q: torch.Tensor, kernel_q: torch.Tensor, w_scale: torch.Tensor,
                 bias: torch.Tensor, a_scale, stride: int = 1,
                 out_dtype: torch.dtype = torch.bfloat16,
                 padding: Optional[int] = None, act: Optional[str] = None,
                 w_packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAME (or ``padding`` on every side) int8 conv of NHWC ``q`` with a
    square HWIO int8 ``kernel_q`` on K4: ``act(conv(q, kernel_q) * (a_scale
    * w_scale) + bias)`` as ``out_dtype``, (B, Ho, Wo, Cout). ``w_packed``
    is ``pack_kernel(kernel_q)`` where the caller keeps it."""
    if q.device.type == "cpu":
        return quant_conv2d_plain(q, kernel_q, w_scale, bias, a_scale, stride, out_dtype,
                                  padding, act)
    _check(q, kernel_q)
    kh, kw, cin, cout = kernel_q.shape
    b, h, w, _ = q.shape
    ho, wo, (pl, _, pt, _) = _out_hw(h, w, kh, stride, padding)
    if w_packed is None:
        w_packed = pack_kernel(kernel_q)
    pad = -cin % CIN_ALIGN
    if kh == 1 and stride == 1 and pl == 0 and pt == 0 and not pad:
        y = k4.quant_matmul(q.reshape(b * h * w, cin), kernel_q.reshape(cin, cout), w_scale,
                            bias, a_scale, act, out_dtype, w_packed=w_packed)
        return y.reshape(b, ho, wo, cout)
    return _window(q, kernel_q, w_scale, bias, a_scale, stride, out_dtype, act, w_packed,
                   ho, wo, pt, pl)


def _window(q: torch.Tensor, kernel_q: torch.Tensor, w_scale, bias, a_scale, stride: int,
            out_dtype: torch.dtype, act: Optional[str], w_packed: torch.Tensor, ho: int,
            wo: int, pt: int, pl: int) -> torch.Tensor:
    """K4's window entry point: (B, ho, wo, Cout) from ``q[b, ho s + i -
    pt, wo s + j - pl, c]``, taps outside ``q`` zero."""
    if q.dtype != torch.int8 or kernel_q.dtype != torch.int8:
        raise TypeError(f"quant_conv2d: int8 operands only, got {q.dtype} and {kernel_q.dtype}")
    if act not in k4.ACTS or out_dtype not in k4._OUT_DTYPES:
        raise ValueError(f"quant_conv2d: act {act!r} or out_dtype {out_dtype} not taken")
    kh, kw, cin, cout = kernel_q.shape
    b, h, w, _ = q.shape
    pad = -cin % CIN_ALIGN
    if pad:  # as pack_kernel pads the weight
        q, cin = F.pad(q, (0, pad)), cin + pad
    ws, bs, sa = k4.launch_operands(q, w_packed, kh * kw * cin, cout, w_scale, bias, a_scale)
    out = torch.empty((b, ho, wo, cout), dtype=out_dtype, device=q.device)
    if out.numel() == 0:
        return out
    k4.launch("quant_conv2d", q, (q, w_packed, ws, bs, sa, out),
              (b, h, w, cin, ho, wo, kh, stride, pt, pl, cout, w_packed.shape[1],
               k4.ACTS[act], k4._OUT_DTYPES[out_dtype]))
    quant_conv2d.window_launches += 1
    return out


# launches of the kernel's window entry point (a subset of quant_matmul.launches)
quant_conv2d.window_launches = 0


def _rows_out(ext: torch.Tensor, k: int, stride: int, pads) -> Tuple[int, int]:
    """(output rows, output columns) of ``ext`` padded by ``pads``."""
    pl, pr, pt, pb = pads
    return ((ext.shape[1] + pt + pb - k) // stride + 1,
            (ext.shape[2] + pl + pr - k) // stride + 1)


def _empty_rows(ext: torch.Tensor, kernel_q: torch.Tensor, wo: int,
                out_dtype: torch.dtype) -> torch.Tensor:
    return torch.empty((ext.shape[0], 0, wo, kernel_q.shape[3]), dtype=out_dtype,
                       device=ext.device)


def quant_conv2d_rows_local_plain(ext: torch.Tensor, kernel_q: torch.Tensor,
                                  w_scale: torch.Tensor, bias: torch.Tensor, a_scale,
                                  stride: int, out_dtype: torch.dtype,
                                  padding: Optional[int], plan: HaloPlan, q: int,
                                  act: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch :func:`quant_conv2d_rows_local`: the extended rows
    padded (ops/conv.py ``row_pads``: zero rows outside the image, the
    image's column pads), their patch matrix through K4's plain version."""
    _check(ext, kernel_q)
    kh, kw, cin, cout = kernel_q.shape
    pads = row_pads(plan, q, ext.shape[2], kh, stride, padding)
    ho, wo = _rows_out(ext, kh, stride, pads)
    if plan.need[q] is None:
        return _empty_rows(ext, kernel_q, wo, out_dtype)
    x = F.pad(ext, (0, 0, *pads))
    im2col_same.calls += 1
    y = k4.quant_matmul_plain(_patches(x, kh, stride, ho, wo),
                              kernel_q.reshape(kh * kw * cin, cout), w_scale, bias, a_scale,
                              act, out_dtype)
    return y.reshape(ext.shape[0], ho, wo, cout)


def quant_conv2d_rows_local(ext: torch.Tensor, kernel_q: torch.Tensor, w_scale: torch.Tensor,
                            bias: torch.Tensor, a_scale, stride: int,
                            out_dtype: torch.dtype, padding: Optional[int], plan: HaloPlan,
                            q: int, act: Optional[str] = None,
                            w_packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rank ``q``'s output rows of :func:`quant_conv2d` from ``ext``, its int8
    input rows ``plan.need[q]`` (ops/halo.py ``extend_rows``), on K4's
    window entry point: the rows of the read outside the image are its row
    pad (zero), the columns the whole image's pad (ops/conv.py
    ``row_pads``). A rank with no output rows returns none and launches
    nothing."""
    if ext.device.type == "cpu":
        return quant_conv2d_rows_local_plain(ext, kernel_q, w_scale, bias, a_scale, stride,
                                             out_dtype, padding, plan, q, act)
    _check(ext, kernel_q)
    kh = kernel_q.shape[0]
    pads = row_pads(plan, q, ext.shape[2], kh, stride, padding)
    ho, wo = _rows_out(ext, kh, stride, pads)
    if plan.need[q] is None:
        return _empty_rows(ext, kernel_q, wo, out_dtype)
    if w_packed is None:
        w_packed = pack_kernel(kernel_q)
    return _window(ext.contiguous(), kernel_q, w_scale, bias, a_scale, stride, out_dtype, act,
                   w_packed, ho, wo, pads[2], pads[0])

"""Banded two-pass inference MBConv (K3): a hand-written Hopper kernel.

Replaces the TPU kernels of ``pldepth_tpu/ops/banded_mbconv.py``:
``_expand_dw_kernel`` (pass 1) and ``_project_kernel`` (pass 2), launched by
``banded_mbconv_infer``. They compute one whole inference MBConv -- 1x1
expand + folded BN + swish, k x k depthwise + BN + swish, the stride-2
subsample, squeeze-excite, 1x1 project + BN, residual -- over horizontal
bands of output rows, for the blocks whose expanded tensor is too large for
VMEM (the B0 stage-2 and stage-3 blocks at 448^2).

The function and its rounding points are the TPU kernel's:

* pass 1, per (image, band): the expand with f32 accumulation, affine and
  swish in f32, cast to the storage dtype; expanded halo rows outside the
  image set to zero *after* the activation (SAME pads the post-activation
  tensor); the depthwise in f32, BN and swish, cast; at stride 2 TF SAME's
  asymmetric form, output row r reading stride-1 rows 2r+1-p .. 2r+1+p
  (columns likewise); write ``g`` and an f32 SE pool partial of the band;
* SE: the partials summed per image in a fixed order, divided by Ho * Wo,
  the MLP in f32 with storage-dtype weights; the scale stays f32;
* pass 2, per band: ``g * scale`` in the storage dtype (the scale cast
  first), the project in f32, BN, cast, the residual added in the storage
  dtype.

``Ho = H // stride``: H and W must be even at stride 2 (K2 takes ``ceil``;
this function raises instead of returning another shape).

What bounds it on the H100: what bounds K2 (ops/fused_mbconv.py): the
expand and project products at the bf16 tensor-core rate, the depthwise at
the f32 CUDA-core rate, and the bytes of x, y and the ``g`` round trip.

The Hopper design (``pldepth_torch/csrc/banded_mbconv.cu``), three launches:

(a) expand + depthwise: one block per (band, column strip, channel group,
    image); 256 threads. A full-width band of the expanded tensor does not
    fit in 227 KB of shared memory (stage2_block0: 34 x 224 x 96 bf16 =
    1.46 MB), so a block holds a tile of it: a strip of 16 output columns
    at stride 1, 8 at stride 2, walked down the band in chunks of 8 output
    rows. The input window of a chunk is ``(8 - 1) * stride + k`` rows by
    ``(strip - 1) * stride + k`` columns; the ``k - stride`` rows two chunks
    share are kept, so each expanded row of a band and strip is computed
    once. bf16: a 64-channel group; the chunk's new x rows are copied into
    shared memory with 16-byte ``cp.async`` requests, the expand runs on
    the tensor cores and the depthwise on the CUDA cores through K2's own
    device functions, in K2's K and tap orders, so ``g`` equals K2's bit for
    bit; h is bf16 in shared memory. f32: a 32-channel slice on CUDA-core
    FMA, h in f32. The block writes ``g`` and one f32 SE partial per
    (image, band, strip). :func:`plan_k3` gives the strip and the shared
    memory.
(b) SE: one block per image sums the (band, strip) partials in a fixed
    order, K2's code (no float atomics: the result is deterministic, as
    K2's is), then runs the MLP.
(c) project: per band, tiles of ``(g * scale) @ wp``, BN affine, residual:
    bf16 on K2's tensor-core tile (csrc/mbconv_common.cuh), f32 on the f32
    tile.

The band stays the unit of ``g``'s writes and of the SE partials, so
``band_rows`` means what it means in JAX. The SE sums K2's partials in
another grouping, so the scale, and through it y, can differ from K2's by
one bf16 rounding.

:func:`banded_mbconv_plain` is the pure-torch twin of the band algorithm
(per band: slice the haloed rows, expand, mask the halo, depthwise,
subsample; partials summed in a fixed order; SE; project), with the bf16
rounding points of :func:`~pldepth_torch.ops.fused_mbconv.mbconv_infer_plain`;
its two halves, :func:`banded_pass1_plain` and :func:`banded_pass2_plain`,
are the plain versions of the two TPU kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from pldepth_torch.ops.fused_mbconv import (
    _DTYPE_CODE,
    CG,
    F32_SLICE,
    N_SMS,
    SMEM_PER_BLOCK,
    STATIC_SMEM,
    MBConvParams,
    _bf16_smem,
    _check,
    _swish,
    cast_params,
)


RC = 8  # output rows per chunk of a band (csrc/banded_mbconv.cu)


class K3Plan(NamedTuple):
    """How K3 cuts one block shape (:func:`plan_k3`)."""

    strip: int  # output columns of a block
    n_strips: int
    kp: int  # bf16: Cin zero-padded to a multiple of 16; 0 for the tap form
    smem: int  # dynamic shared memory of the expand + depthwise block, bytes
    proj_mt: int  # bf16 project tile: 64 * proj_mt pixels


@functools.lru_cache(maxsize=None)
def plan_k3(w: int, cin: int, cout: int, *, kernel: int, stride: int, band: int,
            n_bands: int, batch: int, has_expand: bool, dtype: torch.dtype) -> K3Plan:
    """K3's cut of one block shape: 16-column strips at stride 1, 8 at
    stride 2, an 8-row chunk's window of h in shared memory (bf16 with the
    chunk's x rows and one weight group beside it; f32 a 32-channel
    slice); the bf16 project takes 128-pixel tiles where they give every
    SM one. Raises ValueError where the window does not fit one block."""
    wo = w // stride
    strip = 16 if stride == 1 else 8
    win = ((RC - 1) * stride + kernel) * ((strip - 1) * stride + kernel)
    if dtype == torch.float32:
        return K3Plan(strip, -(-wo // strip), 0, win * F32_SLICE * 4, 1)
    kp = -(-cin // 16) * 16 if has_expand else 0
    smem = _bf16_smem((1, win), kp)
    if smem + STATIC_SMEM > SMEM_PER_BLOCK:
        raise ValueError(f"banded_mbconv_infer: a chunk's window needs {smem} bytes of "
                         f"shared memory at Cin {cin}, more than a block has")
    tiles = n_bands * -(-(band * wo) // 128) * -(-cout // CG) * batch
    return K3Plan(strip, -(-wo // strip), kp, smem, 2 if tiles >= N_SMS else 1)


def pick_band(ho: int) -> int:
    """Output rows per band: a divisor of Ho near 16-32 rows (a copy of
    ``pldepth_tpu/ops/banded_mbconv.py:_pick_band``)."""
    for cand in (32, 28, 16, 14, 8, 7, 4, 2):
        if ho % cand == 0 and cand <= ho:
            return cand
    return ho


def _geometry(x: torch.Tensor, params: MBConvParams, kernel: int, stride: int,
              residual: bool, band_rows: int):
    """Checked (B, H, W, Cin, Ho, Wo, band)."""
    b, hh, ww, cin = _check(x, params, kernel, stride, residual)
    if stride == 2 and (hh % 2 or ww % 2):
        raise ValueError(f"stride 2 needs even H and W, got {hh} x {ww}")
    ho, wo = hh // stride, ww // stride
    band = band_rows or pick_band(ho)
    if band <= 0 or ho % band:
        raise ValueError(f"band_rows {band} must divide output height {ho}")
    return b, hh, ww, cin, ho, wo, band


def banded_mbconv_plain(x: torch.Tensor, p: MBConvParams, *, kernel: int, stride: int,
                        residual: bool, band_rows: int = 0) -> torch.Tensor:
    """Plain PyTorch K3: the band algorithm with the kernel's rounding
    points. x: (B, H, W, Cin) in the storage dtype; returns
    (B, H // stride, W // stride, Cout)."""
    band = _geometry(x, p, kernel, stride, residual, band_rows)[-1]
    g, scale = banded_pass1_plain(x, p, kernel=kernel, stride=stride, band=band)
    return banded_pass2_plain(g, scale, x, p, residual=residual)


def banded_pass1_plain(x: torch.Tensor, p: MBConvParams, *, kernel: int, stride: int,
                       band: int):
    """Pass 1 (``_expand_dw_kernel``) and the SE: per band, slice the
    haloed rows, expand, mask the halo, depthwise, subsample; the band
    partials summed in a fixed order; the SE MLP. Returns (g in the storage
    dtype, the f32 scale (B, Ce))."""
    b, hh, ww, _ = x.shape
    ho, wo = hh // stride, ww // stride
    dt, f32 = x.dtype, torch.float32
    pad = kernel // 2
    in_len = stride * band + 2 * pad
    # band i reads padded rows [stride * band * i + stride - 1, + in_len)
    needed = stride * (ho - band) + (stride - 1) + in_len
    xp = F.pad(x, (0, 0, 0, 0, pad, max(0, needed - pad - hh)))
    ce = p.dw.shape[-1]
    dwk = p.dw.to(dt).to(f32).permute(2, 0, 1).reshape(ce, 1, kernel, kernel)

    gs, parts = [], []
    for i in range(ho // band):
        off = stride * band * i + (stride - 1)
        xb = xp[:, off: off + in_len]
        if p.we is not None:
            h = torch.einsum("bhwc,cd->bhwd", xb.to(f32), p.we.to(dt).to(f32))
            h = _swish(h * p.e_scale.to(f32) + p.e_shift.to(f32)).to(dt)
            true_row = off - pad + torch.arange(in_len, device=x.device)
            inside = (true_row >= 0) & (true_row < hh)
            h = torch.where(inside[None, :, None, None], h, h.new_zeros(()))
        else:
            h = xb  # x's zero pad is the reference pad
        # stride-1 depthwise over the band's rows, columns zero-padded by p
        hn = F.pad(h.to(f32), (0, 0, pad, pad))
        g1 = F.conv2d(hn.permute(0, 3, 1, 2), dwk, groups=ce).permute(0, 2, 3, 1)
        g1 = _swish(g1 * p.d_scale.to(f32) + p.d_shift.to(f32)).to(dt)
        # stride 2: local even rows (global odd), odd columns
        g = g1[:, 0::2, 1::2] if stride == 2 else g1
        gs.append(g)
        parts.append(g.to(f32).sum(dim=(1, 2)))  # (B, Ce) SE pool partial

    pool = parts[0]
    for part in parts[1:]:  # the fixed order of the SE launch
        pool = pool + part
    pool = pool / (ho * wo)
    se = _swish(pool @ p.se_w1.to(dt).to(f32) + p.se_b1.to(f32))
    scale = torch.sigmoid(se @ p.se_w2.to(dt).to(f32) + p.se_b2.to(f32))
    return torch.cat(gs, dim=1), scale


def banded_pass2_plain(g: torch.Tensor, scale: torch.Tensor, x: torch.Tensor,
                       p: MBConvParams, *, residual: bool) -> torch.Tensor:
    """Pass 2 (``_project_kernel``): ``g * scale`` in the storage dtype, the
    project in f32, BN, cast, the residual in the storage dtype."""
    dt, f32 = g.dtype, torch.float32
    g = g * scale.to(dt)[:, None, None, :]
    y = torch.einsum("bhwc,cd->bhwd", g.to(f32), p.wp.to(dt).to(f32))
    y = (y * p.p_scale.to(f32) + p.p_shift.to(f32)).to(dt)
    return y + x if residual else y


def banded_mbconv_infer(x: torch.Tensor, params: MBConvParams, *, kernel: int,
                        stride: int, residual: bool, band_rows: int = 0) -> torch.Tensor:
    """Run one inference MBConv block in row bands. x: (B, H, W, Cin) f32 or
    bf16, contiguous; returns (B, H // stride, W // stride, Cout) in x.dtype.
    ``band_rows=0`` picks the band (:func:`pick_band`); a band that does not
    divide the output height, or odd H or W at stride 2, raises ValueError.

    A CPU tensor takes :func:`banded_mbconv_plain`. A CUDA tensor launches
    the kernel or raises; it never falls back."""
    b, hh, ww, cin, ho, wo, band = _geometry(x, params, kernel, stride, residual, band_rows)
    if x.device.type == "cpu":
        return banded_mbconv_plain(x, params, kernel=kernel, stride=stride,
                                   residual=residual, band_rows=band)
    if x.device.type != "cuda":
        raise RuntimeError(f"banded_mbconv_infer: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("banded_mbconv_infer: x must be contiguous (NHWC)")
    dt = x.dtype
    p = cast_params(params, dt)
    for name, v in p._asdict().items():
        if v is not None and v.device != x.device:
            raise ValueError(f"MBConvParams.{name} is on {v.device}, x on {x.device}")
    ce, cse, cout = p.dw.shape[-1], p.se_w1.shape[-1], p.wp.shape[-1]
    if dt == torch.bfloat16 and (cin % 8 or ce % 8 or cout % 8):
        raise ValueError(f"banded_mbconv_infer: bf16 channels must be multiples of 8, "
                         f"got Cin {cin}, Ce {ce}, Cout {cout}")
    plan = plan_k3(ww, cin, cout, kernel=kernel, stride=stride, band=band, n_bands=ho // band,
                   batch=b, has_expand=p.we is not None, dtype=dt)

    from pldepth_torch.ops._build import load_library

    lib = load_library("banded_mbconv")
    dev = x.device
    y = torch.empty((b, ho, wo, cout), dtype=dt, device=dev)
    g = torch.empty((b, ho, wo, ce), dtype=dt, device=dev)
    partial = torch.empty((b, ho // band, plan.n_strips, ce), dtype=torch.float32, device=dev)
    scale = torch.empty((b, ce), dtype=torch.float32, device=dev)
    ptr = lambda t: ctypes.c_void_p(0 if t is None else t.data_ptr())  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.banded_mbconv_infer(
        _DTYPE_CODE[dt],
        ptr(x), ptr(p.we), ptr(p.e_scale), ptr(p.e_shift),
        ptr(p.dw), ptr(p.d_scale), ptr(p.d_shift),
        ptr(p.se_w1), ptr(p.se_b1), ptr(p.se_w2), ptr(p.se_b2),
        ptr(p.wp), ptr(p.p_scale), ptr(p.p_shift),
        ptr(g), ptr(partial), ptr(scale), ptr(y),
        b, hh, ww, cin, ce, cse, cout, kernel, stride, band,
        int(p.we is not None), int(residual), plan.strip, plan.kp, plan.smem, plan.proj_mt,
        ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"banded_mbconv kernel launch failed: CUDA error {err}")
    banded_mbconv_infer.launches += 1
    return y


# launches of the CUDA kernel (not of the plain version); chip_smoke.py reads it
banded_mbconv_infer.launches = 0

"""Fused inference MBConv (K2): one hand-written Hopper kernel per block.

Replaces the TPU kernel ``pldepth_tpu/ops/fused_mbconv.py:_mbconv_kernel``
(launched by ``fused_mbconv_infer``), which runs a whole inference MBConv per
image with the expanded (H, W, Ce) tensor held in VMEM: 1x1 expand + folded
BN + swish, k x k depthwise (TF SAME) + BN + swish, stride-2 subsample,
squeeze-excite, 1x1 project + BN, residual.

What bounds it on the H100: bytes. Per output pixel the block does a few
hundred to a few thousand flops on a few hundred bytes, far below the
~295 flop/byte at which bf16 tensor cores become the limit. The least
traffic is "read x, write y, read the weights once". The TPU kept the
expanded tensor on chip for the whole image; a Hopper block has at most
227 KB of shared memory, and ``stage2_block0`` at 448^2 expands to 9.6 MB
per image, so that schedule cannot carry over.

The design (``pldepth_torch/csrc/fused_mbconv.cu``), three launches per call:

(a) expand + depthwise: one block per (image, output tile, 32-channel slice).
    The expand is separable by output channel, so each slice recomputes only
    its own channels of the 1x1 expand on the tile's depthwise halo, in
    shared memory; the expanded tensor never reaches device memory. It
    writes ``g`` (the depthwise output, stored dtype) and a per-tile f32
    partial sum for the SE pool.
(b) SE: one block per image reduces the partials in a fixed order (no float
    atomics, so results are deterministic) and runs the SE MLP in f32.
(c) project: a tiled (g * scale) @ wp product with f32 accumulation, BN
    affine and the residual.

So the kernel moves x + y + 2 * g + weights, where the TPU kernel moved
x + y + weights: ``g`` is the one round trip this design pays for the
parallel grid. Plain f32 FMA loops throughout; tensor cores (mma/wgmma) and
TMA are later work (PERF.md).

Rounding points follow ``_mbconv_kernel`` (fused_mbconv.py:112-164): expand
affine and swish in f32 then cast; depthwise accumulated in f32, BN and
swish in f32, cast; SE pool and MLP in f32 with the scale cast to the
storage dtype; project in f32, affine, cast, residual added in the storage
dtype. :func:`mbconv_infer_plain` is the same function in plain PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from pldepth_torch.ops.conv import same_out_and_pad, same_pads

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class MBConvParams(NamedTuple):
    """Folded inference parameters of one MBConv block.

    BN(v) with running stats is the affine v*s + t with
    s = gamma / sqrt(var + eps), t = beta - mean * s.
    """

    we: Optional[torch.Tensor]  # (Cin, Ce) expand 1x1 kernel; None if expand==1
    e_scale: Optional[torch.Tensor]  # (Ce,)
    e_shift: Optional[torch.Tensor]  # (Ce,)
    dw: torch.Tensor  # (k, k, Ce) depthwise kernel
    d_scale: torch.Tensor  # (Ce,)
    d_shift: torch.Tensor  # (Ce,)
    se_w1: torch.Tensor  # (Ce, Cse)
    se_b1: torch.Tensor  # (Cse,)
    se_w2: torch.Tensor  # (Cse, Ce)
    se_b2: torch.Tensor  # (Ce,)
    wp: torch.Tensor  # (Ce, Cout) project 1x1 kernel
    p_scale: torch.Tensor  # (Cout,)
    p_shift: torch.Tensor  # (Cout,)


def fold_bn(gamma, beta, mean, var, eps: float = 1e-3):
    s = gamma / torch.sqrt(var + eps)
    return s, beta - mean * s


def cast_params(p: MBConvParams, dtype: torch.dtype) -> MBConvParams:
    """Matrices in the storage dtype, affine vectors in f32, all contiguous:
    the operand types the kernel takes. Done once per plan, not per call."""
    mats = {"we", "dw", "se_w1", "se_w2", "wp"}
    return MBConvParams(**{
        name: None if v is None else v.to(
            dtype if name in mats else torch.float32).contiguous()
        for name, v in p._asdict().items()
    })


def _swish(v: torch.Tensor) -> torch.Tensor:
    return v * torch.sigmoid(v)


def mbconv_infer_plain(x: torch.Tensor, p: MBConvParams, *, kernel: int,
                       stride: int, residual: bool) -> torch.Tensor:
    """Plain PyTorch K2 with the kernel's rounding points. x: (B, H, W, Cin)
    in the storage dtype; returns (B, ceil(H/s), ceil(W/s), Cout)."""
    dt = x.dtype
    f32 = torch.float32
    if p.we is not None:
        # bf16 x bf16 products are exact in f32: an f32 product of the
        # upcast operands is "storage-dtype inputs, f32 accumulation"
        h = torch.einsum("bhwc,cd->bhwd", x.to(f32), p.we.to(dt).to(f32))
        h = _swish(h * p.e_scale.to(f32) + p.e_shift.to(f32)).to(dt)
    else:
        h = x
    ce = h.shape[-1]
    dwk = p.dw.to(dt).to(f32).permute(2, 0, 1).reshape(ce, 1, kernel, kernel)
    hn = F.pad(h.to(f32), (0, 0, *same_pads(h.shape[1], h.shape[2], kernel, stride)))
    g = F.conv2d(hn.permute(0, 3, 1, 2), dwk, stride=stride, groups=ce)
    g = g.permute(0, 2, 3, 1)
    g = _swish(g * p.d_scale.to(f32) + p.d_shift.to(f32)).to(dt)

    pool = g.to(f32).mean(dim=(1, 2))  # (B, Ce)
    se = _swish(pool @ p.se_w1.to(dt).to(f32) + p.se_b1.to(f32))
    se = se @ p.se_w2.to(dt).to(f32) + p.se_b2.to(f32)
    scale = torch.sigmoid(se).to(dt)
    g = g * scale[:, None, None, :]

    y = torch.einsum("bhwc,cd->bhwd", g.to(f32), p.wp.to(dt).to(f32))
    y = (y * p.p_scale.to(f32) + p.p_shift.to(f32)).to(dt)
    if residual:
        y = y + x
    return y


def _check(x: torch.Tensor, p: MBConvParams, kernel: int, stride: int,
           residual: bool) -> Tuple[int, int, int, int]:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype} not in {list(_DTYPE_CODE)}")
    if kernel not in (3, 5) or stride not in (1, 2):
        raise ValueError(f"kernel {kernel} / stride {stride} not supported")
    b, hh, ww, cin = x.shape
    ce = p.dw.shape[-1]
    cse = p.se_w1.shape[-1]
    cout = p.wp.shape[-1]
    want = {
        "dw": (kernel, kernel, ce), "d_scale": (ce,), "d_shift": (ce,),
        "se_w1": (ce, cse), "se_b1": (cse,), "se_w2": (cse, ce),
        "se_b2": (ce,), "wp": (ce, cout), "p_scale": (cout,),
        "p_shift": (cout,),
    }
    if p.we is not None:
        want.update(we=(cin, ce), e_scale=(ce,), e_shift=(ce,))
    elif cin != ce:
        raise ValueError(f"expand==1 block needs Cin == Ce, got {cin} != {ce}")
    for name, shape in want.items():
        got = tuple(getattr(p, name).shape)
        if got != shape:
            raise ValueError(f"MBConvParams.{name}: shape {got} != {shape}")
    if residual and (stride != 1 or cin != cout):
        raise ValueError("residual needs stride 1 and Cin == Cout")
    return b, hh, ww, cin


def fused_mbconv_infer(x: torch.Tensor, params: MBConvParams, *, kernel: int,
                       stride: int, residual: bool) -> torch.Tensor:
    """Run one inference MBConv block. x: (B, H, W, Cin) f32 or bf16,
    contiguous; returns (B, ceil(H/s), ceil(W/s), Cout) in x.dtype.

    A CPU tensor takes :func:`mbconv_infer_plain`. A CUDA tensor launches the
    kernel or raises; it never falls back."""
    b, hh, ww, cin = _check(x, params, kernel, stride, residual)
    if x.device.type == "cpu":
        return mbconv_infer_plain(x, params, kernel=kernel, stride=stride,
                                  residual=residual)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_mbconv_infer: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("fused_mbconv_infer: x must be contiguous (NHWC)")
    dt = x.dtype
    p = cast_params(params, dt)
    for name, v in p._asdict().items():
        if v is not None and v.device != x.device:
            raise ValueError(f"MBConvParams.{name} is on {v.device}, x on {x.device}")
    ce, cse, cout = p.dw.shape[-1], p.se_w1.shape[-1], p.wp.shape[-1]
    ho, pad_t = same_out_and_pad(hh, kernel, stride)
    wo, pad_l = same_out_and_pad(ww, kernel, stride)

    from pldepth_torch.ops._build import load_library

    lib = load_library("fused_mbconv")
    n_tiles = lib.fused_mbconv_tiles(ho, wo, stride)
    y = torch.empty((b, ho, wo, cout), dtype=dt, device=x.device)
    g = torch.empty((b, ho, wo, ce), dtype=dt, device=x.device)
    partial = torch.empty((b, n_tiles, ce), dtype=torch.float32, device=x.device)
    scale = torch.empty((b, ce), dtype=dt, device=x.device)
    ptr = lambda t: ctypes.c_void_p(0 if t is None else t.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.fused_mbconv_infer(
        _DTYPE_CODE[dt],
        ptr(x), ptr(p.we), ptr(p.e_scale), ptr(p.e_shift),
        ptr(p.dw), ptr(p.d_scale), ptr(p.d_shift),
        ptr(p.se_w1), ptr(p.se_b1), ptr(p.se_w2), ptr(p.se_b2),
        ptr(p.wp), ptr(p.p_scale), ptr(p.p_shift),
        ptr(g), ptr(partial), ptr(scale), ptr(y),
        b, hh, ww, cin, ce, cse, cout, ho, wo, pad_t, pad_l,
        kernel, stride, int(p.we is not None), int(residual),
        ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"fused_mbconv kernel launch failed: CUDA error {err}")
    fused_mbconv_infer.launches += 1
    return y


# launches of the CUDA kernel (not of the plain version); chip_smoke.py reads it
fused_mbconv_infer.launches = 0

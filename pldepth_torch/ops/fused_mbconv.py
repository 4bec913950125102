"""Fused inference MBConv (K2): one hand-written Hopper kernel per block.

Replaces the TPU kernel ``pldepth_tpu/ops/fused_mbconv.py:_mbconv_kernel``
(launched by ``fused_mbconv_infer``), which runs a whole inference MBConv per
image with the expanded (H, W, Ce) tensor held in VMEM: 1x1 expand + folded
BN + swish, k x k depthwise (TF SAME) + BN + swish, stride-2 subsample,
squeeze-excite, 1x1 project + BN, residual.

What bounds it on the H100. Per ff_effnet forward (448^2, batch 8) the
expand and project products are ~20 GFLOP, ~21 us at the bf16 tensor-core
peak; the depthwise (~2.2 GFLOP, which has no tensor-core form) ~33 us at
the f32 CUDA-core peak; x in and y out ~30 us of bytes. The TPU kept the
expanded tensor on chip for the whole image; a Hopper block has at most
227 KB of shared memory, and ``stage2_block0`` at 448^2 expands to 9.6 MB
per image, so that schedule cannot carry over.

The design (``pldepth_torch/csrc/fused_mbconv.cu``), three launches per call:

(a) expand + depthwise: one block per (image, output tile, wide group of
    64-channel groups). bf16: the block copies the tile's haloed x window
    into shared memory once (16-byte ``cp.async``), then for each group of
    its wide group runs the expand on the tensor cores (``mma.sync``
    m16n8k16 bf16 -> f32 from ``ldmatrix``), affine + swish in f32, ``h``
    rounded to bf16 in shared memory, and the depthwise on the CUDA cores;
    the expanded tensor never reaches device memory. It writes ``g`` (the
    depthwise output) and a per-(tile, channel) f32 partial sum for the SE
    pool. :func:`plan_k2` picks the tile and the wide group per block
    shape.
(b) SE: one block per image reduces the partials in a fixed order (no float
    atomics, so results are deterministic) and runs the SE MLP in f32.
(c) project: tiles of (g * scale) @ wp on the tensor cores from a
    ``cp.async`` ring, f32 accumulation, BN affine, the residual.

So the kernel moves x + y + 2 * g + weights, where the TPU kernel moved
x + y + weights: ``g`` is the round trip this design pays for the parallel
grid. The f32 instantiation keeps CUDA-core f32 FMA throughout (32-channel
slices, the f32 project tile): TF32 tensor cores would put it ~1e-3 from
its plain version, outside the f32 gates.

Rounding points follow ``_mbconv_kernel`` (fused_mbconv.py:112-164): expand
accumulated in f32, affine and swish in f32, then cast; depthwise
accumulated in f32, BN and swish in f32, cast; SE pool and MLP in f32 with
the scale cast to the storage dtype; project on g * scale in the storage
dtype, accumulated in f32, affine, cast, residual added in the storage
dtype. :func:`mbconv_infer_plain` is the same function in plain PyTorch.
The bf16 kernel takes channel counts that are multiples of 8 (whole 16-byte
rows; every EfficientNet width is one) and raises on others.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from pldepth_torch.ops.conv import same_out_and_pad, same_pads

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The H100's limits the plan works within (NVIDIA's data sheet)
SMEM_PER_BLOCK = 232_448  # bytes of shared memory one block may use
SMEM_PER_SM = 233_472  # shared memory of one SM
N_SMS = 132
CG = 64  # expanded channels of one bf16 group (csrc/mbconv_common.cuh)
HS = CG + 8  # row stride of h and of a weight group, elements
DW_PAD = 8  # pixels of h past the window that a depthwise run may read
F32_SLICE = 32  # channels of one f32 block
STATIC_SMEM = 4 * (2 * CG + 8 * CG)  # the bf16 block's static es, et, red
# rough per-SM rates of the cost model that ranks the candidate plans
_TENSOR_PER_SM = 989e12 / N_SMS / 2  # mma.sync at half the bf16 peak
_CUDA_PER_SM = 67e12 / N_SMS / 3  # depthwise: bf16 unpack and loads beside each FMA
_BYTES_PER_SM = 3.35e12 / N_SMS
_BLOCK_FIXED_S = 3e-6  # a block's fill and drain
# (rows, columns) of the output tiles plan_k2 weighs, in order of preference;
# the half tiles hold two blocks an SM where a 16 x 16 window holds one
K2_TILES = ((16, 16), (8, 16), (16, 8), (12, 12), (8, 8), (4, 16), (4, 8), (4, 4))


class K2Plan(NamedTuple):
    """How K2 cuts one block shape (:func:`plan_k2`)."""

    th: int  # output tile rows
    tw: int  # output tile columns
    tiles_h: int
    tiles_w: int
    kp: int  # Cin zero-padded to a multiple of 16; 0 for the tap form (no expand)
    groups: int  # channel groups of Ce: 64 channels (bf16), 32 (f32)
    gpb: int  # groups of one block (its wide group)
    wide: int  # blocks along the channels: ceil(groups / gpb)
    smem: int  # dynamic shared memory of the expand + depthwise block, bytes
    proj_mt: int  # bf16 project tile: 64 * proj_mt pixels

    @property
    def n_tiles(self) -> int:
        return self.tiles_h * self.tiles_w


def _window(th: int, tw: int, kernel: int, stride: int) -> Tuple[int, int]:
    return (th - 1) * stride + kernel, (tw - 1) * stride + kernel


def _bf16_smem(win: Tuple[int, int], kp: int) -> int:
    npix = win[0] * win[1]
    return 2 * ((npix + DW_PAD) * HS + (npix * (kp + 8) + kp * HS if kp else 0))


def _bf16_seconds(ho, wo, th, tw, kp, cin, groups, gpb, kernel, stride, batch, smem):
    """Rough device time of the expand + depthwise launch under a plan:
    per group the expand on the tensor cores, the depthwise on the CUDA
    cores and g's bytes; per block the window's bytes and a fixed cost; the
    blocks in waves over the SMs (two resident blocks overlap their
    phases)."""
    win = _window(th, tw, kernel, stride)
    npix = win[0] * win[1]
    per_group = (2 * -(-npix // 16) * 16 * kp * CG / _TENSOR_PER_SM
                 + 2 * th * tw * CG * kernel ** 2 / _CUDA_PER_SM
                 + 2 * (th * tw * CG + (kp * CG if kp else npix * CG)) / _BYTES_PER_SM)
    per_block = gpb * per_group + 2 * npix * cin / _BYTES_PER_SM * bool(kp) + _BLOCK_FIXED_S
    blocks = -(-ho // th) * -(-wo // tw) * -(-groups // gpb) * batch
    resident = 2 if SMEM_PER_SM // (smem + STATIC_SMEM + 1024) >= 2 else 1
    return -(-blocks // (N_SMS * resident)) * per_block * (1.5 if resident == 2 else 1.0)


@functools.lru_cache(maxsize=None)
def plan_k2(h: int, w: int, cin: int, ce: int, cout: int, *, kernel: int, stride: int,
            batch: int, has_expand: bool, dtype: torch.dtype) -> K2Plan:
    """K2's cut of one block shape: the output tile, the channel groups of
    a block and its shared memory; the launcher takes every number from
    here (memoised: a pure function of its arguments). bf16: of the tiles
    in :data:`K2_TILES` (each side capped by the output) and every wide
    group whose window, h and weight group fit one block's shared memory,
    the one the cost model (:func:`_bf16_seconds`) ranks fastest, ties to
    the earlier tile and then the wider group; the project takes 128-pixel
    tiles where they give every SM one. f32: 16-pixel square tiles at
    stride 1, 8 at stride 2, 32-channel slices."""
    ho, wo = -(-h // stride), -(-w // stride)
    if dtype == torch.float32:
        t = 16 if stride == 1 else 8
        win = _window(t, t, kernel, stride)
        groups = -(-ce // F32_SLICE)
        return K2Plan(t, t, -(-ho // t), -(-wo // t), 0, groups, 1, groups,
                      win[0] * win[1] * F32_SLICE * 4, 1)
    kp = -(-cin // 16) * 16 if has_expand else 0
    groups = -(-ce // CG)
    best = None
    for th, tw in K2_TILES:
        th, tw = min(th, ho), min(tw, wo)
        smem = _bf16_smem(_window(th, tw, kernel, stride), kp)
        if smem + STATIC_SMEM > SMEM_PER_BLOCK:
            continue
        for gpb in range(groups, 0, -1):
            if gpb < groups and -(-groups // gpb) == -(-groups // (gpb + 1)):
                continue  # the same number of blocks as a wider group
            secs = _bf16_seconds(ho, wo, th, tw, kp, cin, groups, gpb, kernel, stride, batch,
                                 smem)
            if best is None or secs < best[0] * (1 - 1e-9):
                best = (secs, K2Plan(th, tw, -(-ho // th), -(-wo // tw), kp, groups, gpb,
                                     -(-groups // gpb), smem, 1))
    if best is None:
        raise ValueError(f"no K2 tile fits {SMEM_PER_BLOCK} bytes of shared memory "
                         f"(Cin {cin}, kernel {kernel}, stride {stride})")
    plan = best[1]
    proj_tiles = -(-(ho * wo) // 128) * -(-cout // CG) * batch
    return plan._replace(proj_mt=2 if proj_tiles >= N_SMS else 1)


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
    if dt == torch.bfloat16 and (cin % 8 or ce % 8 or cout % 8):
        raise ValueError(f"fused_mbconv_infer: bf16 channels must be multiples of 8, "
                         f"got Cin {cin}, Ce {ce}, Cout {cout}")
    ho, pad_t = same_out_and_pad(hh, kernel, stride)
    wo, pad_l = same_out_and_pad(ww, kernel, stride)
    plan = plan_k2(hh, ww, cin, ce, cout, kernel=kernel, stride=stride, batch=b,
                   has_expand=p.we is not None, dtype=dt)

    from pldepth_torch.ops._build import load_library

    lib = load_library("fused_mbconv")
    y = torch.empty((b, ho, wo, cout), dtype=dt, device=x.device)
    g = torch.empty((b, ho, wo, ce), dtype=dt, device=x.device)
    partial = torch.empty((b, plan.n_tiles, ce), dtype=torch.float32, device=x.device)
    scale = torch.empty((b, ce), dtype=dt, device=x.device)
    ptr = lambda t: ctypes.c_void_p(0 if t is None else t.data_ptr())  # noqa: E731
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
        plan.th, plan.tw, plan.kp, plan.gpb, plan.wide, plan.smem, plan.proj_mt,
        ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"fused_mbconv kernel launch failed: CUDA error {err}")
    fused_mbconv_infer.launches += 1
    return y


# launches of the CUDA kernel (not of the plain version); chip_smoke.py reads it
fused_mbconv_infer.launches = 0

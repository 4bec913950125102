"""int8 matmul with a fused f32 dequant / bias / activation epilogue (K4).

Replaces the TPU kernel ``pldepth_tpu/ops/quant_matmul.py:_kernel``
(launched by ``quant_matmul``): (M, K) int8 @ (K, N) int8 with an int32
accumulator that never leaves the chip, then

    y = act(acc * (w_scale[n] * a_scale) + bias[n])     (f32)

stored as ``out_dtype``. The CUDA source is ``pldepth_torch/csrc/
quant_matmul.cu``: shared-memory tiles packed as int8x4 words and ``__dp4a``
into int32 register accumulators, the epilogue in registers.

The TPU kernel's ``pick_tile_m`` (M must divide by an 8-aligned tile) and
``QUANT_PALLAS_MIN_K`` (route only K >= 256) are rules of the TPU's matrix
unit and are not carried over: the kernel takes any M, K and N, masks the
ragged tails, and K need not be a multiple of 4. In the port every dense
int8 conv site runs here (ops/quant_conv.py), since eager PyTorch has no
int8 convolution on CUDA. There is no opt-in switch: a CUDA tensor launches
the kernel or raises, a CPU tensor takes :func:`quant_matmul_plain`.
``quant_matmul.launches`` counts kernel launches (chip_smoke.py reads it).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

ACTS = {None: 0, "swish": 1, "relu": 2}
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _scale_tensor(a_scale: Union[float, torch.Tensor], device: torch.device) -> torch.Tensor:
    """``a_scale`` as one f32 on ``device`` (a tensor stays on the device:
    no host read-back)."""
    return torch.as_tensor(a_scale, dtype=torch.float32, device=device).reshape(1)


def _epilogue(acc: torch.Tensor, w_scale: torch.Tensor, bias: torch.Tensor,
              a_scale: torch.Tensor, act: Optional[str], out_dtype: torch.dtype) -> torch.Tensor:
    y = acc * (w_scale.to(torch.float32) * a_scale) + bias.to(torch.float32)
    if act == "swish":
        y = y * torch.sigmoid(y)
    elif act == "relu":
        y = torch.relu(y)
    return y.to(out_dtype)


def quant_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                       bias: torch.Tensor, a_scale: Union[float, torch.Tensor],
                       act: Optional[str] = None,
                       out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch K4. The int32 accumulator is exact on either device:
    an int64 product on the CPU; on the card an f64 product of the int8
    values (``torch.mm`` has no CUDA kernel for integers; |acc| <= 127^2 K <
    2^53). It is rounded to f32 once, as the kernel's int->float is."""
    if x.is_cuda:
        acc = torch.mm(x.to(torch.float64), w_q.to(torch.float64))
    else:
        acc = torch.mm(x.to(torch.int64), w_q.to(torch.int64))
    return _epilogue(acc.to(torch.float32), w_scale, bias, _scale_tensor(a_scale, x.device),
                     act, out_dtype)


def _check(x, w_q, w_scale, bias, act, out_dtype):
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"quant_matmul: x {tuple(x.shape)} and w_q {tuple(w_q.shape)} "
                         "must be (M, K) and (K, N)")
    if x.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"quant_matmul: int8 operands only, got {x.dtype} and {w_q.dtype}")
    if x.shape[1] == 0:
        raise ValueError("quant_matmul: K must be at least 1")
    n = w_q.shape[1]
    if tuple(w_scale.shape) != (n,) or tuple(bias.shape) != (n,):
        raise ValueError(f"quant_matmul: w_scale {tuple(w_scale.shape)} and bias "
                         f"{tuple(bias.shape)} must be ({n},)")
    if act not in ACTS:
        raise ValueError(f"quant_matmul: act {act!r} not in {list(ACTS)}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"quant_matmul: out_dtype {out_dtype} not in {list(_OUT_DTYPES)}")
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"quant_matmul: unsupported device {x.device}")


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                 bias: torch.Tensor, a_scale: Union[float, torch.Tensor],
                 act: Optional[str] = None,
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) ``out_dtype`` (f32 or bf16):
    ``act(acc * (a_scale * w_scale) + bias)``, ``act`` in {None, "swish",
    "relu"}. ``a_scale`` is a float or a one-element tensor."""
    _check(x, w_q, w_scale, bias, act, out_dtype)
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w_q, w_scale, bias, a_scale, act, out_dtype)
    dev = x.device
    if not (x.is_contiguous() and w_q.is_contiguous()):
        raise ValueError("quant_matmul: x and w_q must be contiguous (row-major)")
    ws = w_scale.to(torch.float32).contiguous()
    b = bias.to(torch.float32).contiguous()
    sa = _scale_tensor(a_scale, dev)
    for name, t in (("w_q", w_q), ("w_scale", ws), ("bias", b)):
        if t.device != dev:
            raise ValueError(f"quant_matmul: {name} is on {t.device}, x on {dev}")
    m, k = x.shape
    n = w_q.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out

    from pldepth_torch.ops._build import load_library

    fn = load_library("quant_matmul").quant_matmul
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(x), ptr(w_q), ptr(ws), ptr(b), ptr(sa), ptr(out), m, k, n,
                 ACTS[act], _OUT_DTYPES[out_dtype], ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error {err}")
    quant_matmul.launches += 1
    return out


# launches of the CUDA kernel (not of the plain version); chip_smoke.py reads it
quant_matmul.launches = 0

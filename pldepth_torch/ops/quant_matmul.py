"""int8 matmul with a fused f32 dequant / bias / activation epilogue (K4).

Replaces the TPU kernel ``pldepth_tpu/ops/quant_matmul.py:_kernel``
(launched by ``quant_matmul``): (M, K) int8 @ (K, N) int8 with an int32
accumulator that never leaves the chip, then

    y = act(acc * (w_scale[n] * a_scale) + bias[n])     (f32)

stored as ``out_dtype``. The CUDA source is ``pldepth_torch/csrc/
quant_matmul.cu``: the product runs on the int8 tensor cores (``wgmma``
m64nNk32 at long K, else ``mma.sync`` m16n8k32, into int32 registers) from
a ring of shared-memory stages fed by ``cp.async``, the epilogue in
registers. The same kernel reads the
k x k windows of an NHWC activation in place (ops/quant_conv.py), so no
patch matrix is written on the card.

The kernel reads the weight K-major: :func:`pack_weight` turns the (K, N)
matrix, or a flax HWIO ``kernel_q``, into (N, Kp) with K rounded up to
``K_STEP`` and zero-filled. Serving packs once per site
(models/quantize.py:QuantConv.derived) and hands the pack in as
``w_packed``; :func:`quant_matmul` packs on the fly when it gets none.

The TPU kernel's ``pick_tile_m`` (M must divide by an 8-aligned tile) and
``QUANT_PALLAS_MIN_K`` (route only K >= 256) are rules of the TPU's matrix
unit and are not carried over: the kernel takes any M, K and N and masks
the ragged tails. There is no opt-in switch: a CUDA tensor launches the
kernel or raises, a CPU tensor takes :func:`quant_matmul_plain`.
``quant_matmul.launches`` counts every K4 launch, through either entry
point (chip_smoke.py reads it).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

ACTS = {None: 0, "swish": 1, "relu": 2}
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
K_STEP = 64  # bytes of K the kernel consumes per step (csrc/quant_matmul.cu: kBK)


def pack_weight(w_q: torch.Tensor) -> torch.Tensor:
    """The weight as the kernel reads it: (N, Kp) int8, K-major, with Kp = K
    rounded up to ``K_STEP`` and the tail zero. ``w_q`` is the (K, N) matrix
    or a flax HWIO ``kernel_q`` (kh, kw, Cin, Cout), whose K runs (window
    row, window column, input channel)."""
    w2 = w_q.reshape(-1, w_q.shape[-1])
    k, n = w2.shape
    packed = w2.new_zeros((n, -(-k // K_STEP) * K_STEP))
    packed[:, :k] = w2.t()
    return packed


def _scale_tensor(a_scale: Union[float, torch.Tensor], device: torch.device) -> torch.Tensor:
    """``a_scale`` as one f32 on ``device`` (a tensor stays on the device:
    no host read-back)."""
    if (isinstance(a_scale, torch.Tensor) and a_scale.dtype == torch.float32
            and a_scale.device == device and a_scale.numel() == 1):
        return a_scale
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


def launch_operands(x: torch.Tensor, w_packed: torch.Tensor, k: int, n: int,
                    w_scale: torch.Tensor, bias: torch.Tensor,
                    a_scale: Union[float, torch.Tensor]):
    """Check the card-side operands of one K4 launch (``x`` is the int8
    activation, 2-D or NHWC) and return (w_scale, bias, a_scale) as
    contiguous f32 tensors on x's device."""
    dev = x.device
    if not x.is_contiguous():
        raise ValueError("quant_matmul: the int8 activation must be contiguous")
    if tuple(w_scale.shape) != (n,) or tuple(bias.shape) != (n,):
        raise ValueError(f"quant_matmul: w_scale {tuple(w_scale.shape)} and bias "
                         f"{tuple(bias.shape)} must be ({n},)")
    if (w_packed.dtype != torch.int8 or not w_packed.is_contiguous()
            or tuple(w_packed.shape) != (n, -(-k // K_STEP) * K_STEP)):
        raise ValueError(f"quant_matmul: w_packed {tuple(w_packed.shape)} {w_packed.dtype} is "
                         f"not pack_weight's ({n}, K {k} rounded up to {K_STEP}) int8")
    for name, t in (("w_packed", w_packed), ("w_scale", w_scale), ("bias", bias)):
        if t.device != dev:
            raise ValueError(f"quant_matmul: {name} is on {t.device}, x on {dev}")
    ws, b = (t if t.dtype == torch.float32 and t.is_contiguous()
             else t.to(torch.float32).contiguous() for t in (w_scale, bias))
    return ws, b, _scale_tensor(a_scale, dev)


def launch(symbol: str, x: torch.Tensor, tensors, ints) -> None:
    """Call the C entry point ``symbol`` of csrc/quant_matmul.cu on x's
    device and stream; raise unless it returns 0; count the launch."""
    from pldepth_torch.ops._build import load_library

    fn = getattr(load_library("quant_matmul"), symbol)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[t.data_ptr() for t in tensors], *ints, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")
    quant_matmul.launches += 1


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                 bias: torch.Tensor, a_scale: Union[float, torch.Tensor],
                 act: Optional[str] = None,
                 out_dtype: torch.dtype = torch.bfloat16,
                 w_packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) ``out_dtype`` (f32 or bf16):
    ``act(acc * (a_scale * w_scale) + bias)``, ``act`` in {None, "swish",
    "relu"}. ``a_scale`` is a float or a one-element tensor. ``w_packed``
    is ``pack_weight(w_q)`` where the caller keeps it (the card's route
    reads only the pack; the CPU's only ``w_q``)."""
    _check(x, w_q, w_scale, bias, act, out_dtype)
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w_q, w_scale, bias, a_scale, act, out_dtype)
    if w_packed is None:
        if w_q.device != x.device:
            raise ValueError(f"quant_matmul: w_q is on {w_q.device}, x on {x.device}")
        w_packed = pack_weight(w_q)
    m, k = x.shape
    n = w_q.shape[1]
    ws, b, sa = launch_operands(x, w_packed, k, n, w_scale, bias, a_scale)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    launch("quant_matmul", x, (x, w_packed, ws, b, sa, out),
           (m, k, n, w_packed.shape[1], ACTS[act], _OUT_DTYPES[out_dtype]))
    return out


# launches of the CUDA kernel through either entry point (not of the plain
# version); chip_smoke.py reads it
quant_matmul.launches = 0

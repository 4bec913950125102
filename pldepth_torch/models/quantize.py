"""Post-training int8 quantization for serving (``pldepth_tpu/models/quantize.py``).

Scheme: symmetric and static, per-output-channel weights and per-tensor
activations, on top of the BN-folded graph (models/bn_fold.py):

* weights: ``w_scale[c] = max(max|W[..., c]|, 1e-12) / 127``, ``kernel_q =
  clip(round(W / w_scale), -127, 127)`` int8 in flax HWIO; the bias stays f32;
* activations: ``a_scale = max(amax, 1e-12) / 127``, with ``amax`` the max
  |input| a site sees over calibration batches run through the same graph
  in calibrate mode (weights already dequantized from int8);
* zero-point 0, so SAME zero padding is exact in the int8 domain.

Sites (``make_conv``): the stem, every MBConv expand, depthwise and project
conv, the top conv and the decoder's ``conv0``-``conv4``. Squeeze-excite,
the head, the fused tail and every activation stay float. A dense site
quantizes its input in the compute dtype op by op (``inv = (1/a_scale)``
rounded to it, then multiply, round half to even, clip), runs the int8
conv on K4 (ops/quant_conv.py, ops/quant_matmul.py: int8 tensor cores, the
k x k window read in place, an f32 epilogue) from the site's K-major weight
pack, made once per value of ``kernel_q``, and dequantizes with ``a_eff = 1
/ inv``, the scale the input was really divided by. Depthwise sites keep
int8 weights with compute-dtype activations: a dequantized depthwise conv
plus a bias.

The JAX package's default int8 graph rounds its dequant epilogue in bf16
(an XLA int8 conv, then bf16 multiply-add); its Pallas kernel ``_kernel``
does it in f32. The port follows the kernel (ROADMAP.md §3 gives the gap).

Under spatial sharding (``rows``, ops/halo.py) a dense site quantizes its
rank's rows, exchanges the int8 halo and runs K4's row-local window read
(ops/quant_conv.py ``quant_conv2d_rows_local``); a depthwise site is the
sharded float conv. Calibration runs unsharded.

Flow: :func:`quantize_variables` folds BN, packs every site into
``{kernel_q, w_scale, bias, a_scale}``, runs the calibration forwards, and
returns the ``state_dict`` of the ``quant="int8"`` model. Its two halves,
:func:`pack_module` and :func:`calibrate`, are public so that
``Trainer.prepare_quant`` packs once per model and calibrates per call.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Optional

import torch
from torch import nn

from pldepth_torch.models.bn_fold import fold_module
from pldepth_torch.models.layers import BatchNorm, Conv, TrainPass
from pldepth_torch.ops.conv import conv2d_same_nhwc, conv_row_plan
from pldepth_torch.ops.halo import RowShard, abs_max, extend_rows
from pldepth_torch.ops.quant_conv import pack_kernel, quant_conv2d, quant_conv2d_rows_local


def activation_inv(a_scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``inv = 1 / a_scale`` rounded to the compute dtype: the factor a
    site's input is multiplied by before rounding (``a_eff = 1 / inv``)."""
    return (1.0 / a_scale).to(dtype)


def quantize_activation(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """``clip(round(x * inv), -127, 127)`` as int8, each op in ``inv``'s
    dtype in turn (round half to even), as the JAX graph does it."""
    return torch.clamp(torch.round(x.to(inv.dtype) * inv), -127, 127).to(torch.int8)


class QuantConv(nn.Module):
    """Biased conv in int8 (``calibrate=False``) or in the compute dtype with
    dequantized weights (``calibrate=True``, recording ``amax``). Buffers:
    ``kernel_q`` int8 (kh, kw, Cin/groups, Cout), ``w_scale`` (Cout,) f32,
    ``bias`` (Cout,) f32, ``a_scale`` () f32 -- the JAX parameter names and
    layout, so one packed ``state_dict`` serves both modes."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1, calibrate: bool = False,
                 dtype: torch.dtype = torch.bfloat16, padding: Optional[int] = None):
        super().__init__()
        self.stride, self.groups, self.dtype = stride, groups, dtype
        self.padding = padding  # None: SAME; else explicit, every side
        self.calibrate = calibrate
        self.register_buffer("kernel_q", torch.zeros(
            kernel, kernel, in_ch // groups, out_ch, dtype=torch.int8))
        self.register_buffer("w_scale", torch.ones(out_ch))
        self.register_buffer("bias", torch.zeros(out_ch))
        self.register_buffer("a_scale", torch.ones(()))
        self.amax: Optional[torch.Tensor] = None  # calibrate mode: max |input| so far
        self._memo = None

    derivations = 0  # times any site made its derived tensors (and K4 pack)

    def derived(self):
        """(dequantized OIHW weight in the compute dtype, inv, a_eff), made
        once per value of the buffers, together with :meth:`packed_weight`."""
        key = tuple((t.data_ptr(), t._version) for t in (self.kernel_q, self.w_scale,
                                                          self.a_scale))
        if self._memo is None or self._memo[0] != key:
            QuantConv.derivations += 1
            with torch.no_grad():
                w = (self.kernel_q.to(torch.float32) * self.w_scale).to(self.dtype)
                inv = activation_inv(self.a_scale, self.dtype)
                dense_int8 = self.groups == 1 and not self.calibrate
                self._memo = (key, w.permute(3, 2, 0, 1).contiguous(), inv,
                              1.0 / inv.to(torch.float32),
                              pack_kernel(self.kernel_q) if dense_int8 else None)
        return self._memo[1:4]

    def packed_weight(self) -> Optional[torch.Tensor]:
        """``kernel_q`` as K4 reads it (ops/quant_conv.py:pack_kernel) at a
        dense int8 site, else None; re-made when ``kernel_q`` changes."""
        self.derived()
        return self._memo[4]

    def forward(self, x: torch.Tensor, rows: Optional[RowShard] = None) -> torch.Tensor:
        """``rows``: x holds this rank's image rows (spatial sharding), and
        so does the result."""
        dt = self.dtype
        w, inv, a_eff = self.derived()
        if self.calibrate:
            if rows is not None:
                raise ValueError("calibration runs unsharded (Trainer.prepare_quant)")
            amax = abs_max(x.to(torch.float32))
            self.amax = amax if self.amax is None else torch.maximum(self.amax, amax)
            y = conv2d_same_nhwc(x.to(dt), w, self.stride, self.groups, self.padding)
            return (y.to(torch.float32) + self.bias).to(dt)
        if self.groups > 1:
            # depthwise: int8 weights, compute-dtype activations
            y = conv2d_same_nhwc(x.to(dt), w, self.stride, self.groups, self.padding, rows)
            return y + self.bias.to(dt)
        q = quantize_activation(x, inv)
        k = self.kernel_q.shape[0]
        if rows is None or (k == 1 and self.stride == 1):  # a 1x1 stride-1 site reads no halo
            return quant_conv2d(q, self.kernel_q, self.w_scale, self.bias, a_eff, self.stride,
                                out_dtype=dt, padding=self.padding,
                                w_packed=self._memo[4])  # derived() above made it current
        plan = conv_row_plan(rows, k, self.stride, self.padding)
        return quant_conv2d_rows_local(extend_rows(q, rows, plan), self.kernel_q, self.w_scale,
                                       self.bias, a_eff, self.stride, dt, self.padding, plan,
                                       rows.index, w_packed=self._memo[4])


def make_conv(quant, dtype: torch.dtype, in_ch: int, out_ch: int, kernel: int,
              stride: int = 1, groups: int = 1, bias: bool = True,
              padding: Optional[int] = None) -> nn.Module:
    """The conv at a quantization site: :class:`Conv` normally,
    :class:`QuantConv` under ``quant`` ("int8" serving or "calib").
    ``padding`` None is SAME, an int pads every side by that much."""
    if quant:
        return QuantConv(in_ch, out_ch, kernel, stride, groups,
                         calibrate=(quant == "calib"), dtype=dtype, padding=padding)
    return Conv(in_ch, out_ch, kernel, stride, groups, bias, dtype, padding)


class ConvBNScope(nn.Module):
    """A scope of conv sites, each followed by its BatchNorm unless the graph
    is folded (``bn_fold`` or ``quant``). BN ``X`` sits beside conv
    ``X.replace("conv", "bn")``, the flax names and the fold's pairing rule.
    ``add_conv`` makes the pair (BN eps ``bn_eps``); ``conv_bn`` runs the
    conv, then its BN, cast to the compute dtype."""

    def __init__(self, dtype: torch.dtype, bn_fold: bool, quant, bn_eps: float = 1e-3):
        super().__init__()
        self.dtype, self.quant, self.bn_eps = dtype, quant, bn_eps
        self.fold = bn_fold or bool(quant)

    def add_conv(self, conv: str, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 bias: bool = True, padding: Optional[int] = None) -> None:
        self.add_module(conv, make_conv(self.quant, self.dtype, in_ch, out_ch, kernel,
                                        stride=stride, bias=bias, padding=padding))
        if not self.fold:
            self.add_module(conv.replace("conv", "bn"), BatchNorm(out_ch, eps=self.bn_eps))

    def conv_bn(self, x: torch.Tensor, conv: str, train: Optional[TrainPass],
                rows=None) -> torch.Tensor:
        """``rows``: x holds this rank's image rows (spatial sharding)."""
        x = getattr(self, conv)(x) if rows is None else getattr(self, conv)(x, rows)
        if self.fold:
            return x
        return getattr(self, conv.replace("conv", "bn"))(x, train).to(self.dtype)


def quant_sites(module: nn.Module) -> Dict[str, QuantConv]:
    return {name: m for name, m in module.named_modules() if isinstance(m, QuantConv)}


def _pack_params(template: Mapping[str, torch.Tensor],
                 folded: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fill a quant model's ``state_dict`` (``template``, for its names)
    from BN-folded float tensors: each site's folded ``{weight, bias}``
    becomes ``{kernel_q, w_scale, bias, a_scale=1}``; every other tensor
    copies through by name."""
    sites = {k[: -len(".kernel_q")] for k in template if k.endswith(".kernel_q")}
    out: Dict[str, torch.Tensor] = {}
    for key in template:
        site, _, leaf = key.rpartition(".")
        if site in sites:
            if leaf != "kernel_q":
                continue
            src = folded.get(f"{site}.weight")
            if src is None:
                raise ValueError(f"no folded conv at {site!r} to quantize")
            w = src.to(torch.float32).permute(2, 3, 1, 0)  # OIHW -> HWIO
            w_scale = torch.clamp(w.abs().amax(dim=(0, 1, 2)), min=1e-12) / 127.0
            # contiguous HWIO: K4 reads it as the row-major (kh kw Cin, Cout) matrix
            out[f"{site}.kernel_q"] = torch.clamp(torch.round(w / w_scale), -127, 127).to(
                torch.int8).contiguous()
            out[f"{site}.w_scale"] = w_scale
            bias = folded.get(f"{site}.bias")
            out[f"{site}.bias"] = (bias.to(torch.float32) if bias is not None
                                   else torch.zeros_like(w_scale))
            out[f"{site}.a_scale"] = torch.ones((), device=w.device)
        elif key not in folded:
            raise ValueError(f"missing folded tensor {key!r}")
        else:
            out[key] = folded[key]
    return out


def _write_scales(params: Mapping[str, torch.Tensor],
                  amax: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Calibrated ``a_scale = max(amax, 1e-12) / 127`` per site."""
    out = dict(params)
    for site, a in amax.items():
        out[f"{site}.a_scale"] = torch.clamp(a.to(torch.float32), min=1e-12) / 127.0
    return out


def pack_module(module: nn.Module, calib_module: nn.Module) -> Dict[str, torch.Tensor]:
    """BN-fold ``module`` and quantize its weights into the names of
    ``calib_module`` (``a_scale`` still 1)."""
    with torch.no_grad():
        return _pack_params(calib_module.state_dict(), fold_module(module))


@torch.no_grad()
def calibrate(calib_module: nn.Module, packed: Mapping[str, torch.Tensor],
              calib_batches: Iterable[torch.Tensor],
              amax_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
              ) -> Dict[str, torch.Tensor]:
    """Run ``calib_module`` (``quant="calib"``, holding ``packed``) over the
    normalized batches; returns ``packed`` with the calibrated scales.
    ``amax_reduce`` maps the stacked per-site maxima to the ones to use
    (data parallelism: the all-reduce max over the ranks)."""
    sites = quant_sites(calib_module)
    for m in sites.values():
        m.amax = None
    n = 0
    for batch in calib_batches:
        calib_module(batch)
        n += 1
    if n == 0:
        raise ValueError("calibration needs at least one batch")
    amax = {name: m.amax for name, m in sites.items()}
    if amax_reduce is not None:
        names = list(amax)
        amax = dict(zip(names, amax_reduce(torch.stack([amax[k] for k in names])).unbind()))
    return _write_scales(packed, amax)


def quantize_variables(module: nn.Module, calib_module: nn.Module,
                       calib_batches: Iterable[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A float model + calibration batches -> the ``state_dict`` of its
    ``quant="int8"`` twin. ``calib_module`` is the model built with
    ``quant="calib"``; ``calib_batches`` are normalized image batches."""
    packed = pack_module(module, calib_module)
    calib_module.load_state_dict(packed, assign=True)
    return calibrate(calib_module, packed, calib_batches)

"""EfficientNet encoder family (B0..B7, smoke) with decoder feature taps.

Port of ``pldepth_tpu/models/efficientnet.py``: NHWC tensors, f32 params
cast to the compute dtype at use, f32 batch-norm with eps 1e-3. Submodule
names are the flax ones (``stem_conv``, ``stage2_block0.dw_conv``,
``se.reduce`` ...), so models/pretrained.py maps weights by name alone.
A forward given a ``TrainPass`` (models/layers.py) runs in train mode:
batch-statistics BN, and drop-path on the residual blocks at rate
``drop_connect_rate * block_idx / total_blocks`` with draws from the pass's
generator. ``bn_fold=True`` builds the inference graph with BN folded into
biased convs (models/bn_fold.py); ``quant`` ("int8" or "calib") builds it
with the quantization sites of models/quantize.py, which implies the fold.
``qres`` ("int8" or "bf16") trains with every BN(+swish) as one unit whose
backward reads x̂ compressed (ops/qres.py ``FusedBNAct``, same parameter
names), and with "int8" the squeeze-excite multiply through ``mul_q8``.

A forward given ``rows`` (ops/halo.py ``RowShard`` at the input's level) is
spatially sharded: the input holds this rank's image rows, every conv reads
its halo, the squeeze-excite means sum over the model ranks, and the top
and the taps are this rank's rows of their levels. :data:`SPATIAL_LEVELS`
stride-2 steps take the input to the top.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from pldepth_torch.core.device import wide
from pldepth_torch.core.mesh import batch_rand
from pldepth_torch.models.layers import BatchNorm, Conv, TrainPass, swish
from pldepth_torch.models.quantize import make_conv
from pldepth_torch.ops.halo import RowShard
from pldepth_torch.ops.qres import FusedBNAct, mul_q8

# (expand_ratio, channels, repeats, stride, kernel) for B0, per stage 1..7.
_STAGE_DEFS = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

# width_coefficient, depth_coefficient; "smoke" is the 7-block CI scaling
VARIANTS: Dict[str, Tuple[float, float]] = {
    "smoke": (0.25, 0.25),
    "b0": (1.0, 1.0),
    "b1": (1.0, 1.1),
    "b2": (1.1, 1.2),
    "b3": (1.2, 1.4),
    "b4": (1.4, 1.8),
    "b5": (1.6, 2.2),
    "b6": (1.8, 2.6),
    "b7": (2.0, 3.1),
}

# stages whose first-block expand activation feeds the decoder
DECODER_TAP_STAGES = (3, 4, 6)
# stride-2 steps from the input to the top (the stem's and the stages')
SPATIAL_LEVELS = 1 + sum(s == 2 for (_, _, _, s, _) in _STAGE_DEFS)


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def _bn(ch: int, qres, dtype: torch.dtype, act: Optional[str]) -> BatchNorm:
    """The BN after a conv: ``FusedBNAct`` under ``qres`` (it applies
    ``act`` itself), else a plain ``BatchNorm``."""
    return FusedBNAct(ch, act, qres, dtype) if qres else BatchNorm(ch)


def _bn_act(bn: BatchNorm, x: torch.Tensor, train: Optional[TrainPass],
            dtype: torch.dtype, act: Optional[str]) -> torch.Tensor:
    """``act(bn(x))`` in the compute dtype, the same values either way."""
    if isinstance(bn, FusedBNAct):
        return bn(x, train)
    y = bn(x, train).to(dtype)
    return swish(y) if act == "swish" else y


class SqueezeExcite(nn.Module):
    """``exact_mean``: the spatial mean is summed in float64 and rounded
    once, so the whole image and its row-sharded pieces give the same bits
    (the int8 graph: a mean one bit apart flips the int8 rounding of the
    activations it gates, and the sharded step leaves the one-process step)."""

    def __init__(self, ch: int, reduce_ch: int, dtype: torch.dtype = torch.bfloat16,
                 qres=None, exact_mean: bool = False):
        super().__init__()
        self.reduce = Conv(ch, reduce_ch, 1, dtype=dtype)
        self.expand = Conv(reduce_ch, ch, 1, dtype=dtype)
        self.dtype, self.qres, self.exact_mean = dtype, qres, exact_mean

    def forward(self, x: torch.Tensor, train: Optional[TrainPass] = None,
                rows: Optional[RowShard] = None) -> torch.Tensor:
        if self.exact_mean:
            se = x.sum(dim=(1, 2), keepdim=True, dtype=torch.float64)
            if rows is not None:
                se = rows.mesh.model_sum(se)
            se = se / ((x.shape[1] if rows is None else rows.height) * x.shape[2])
        elif rows is None:
            se = wide(x).mean(dim=(1, 2), keepdim=True)
        else:  # the rank's row sums, summed over the model ranks
            se = rows.mesh.model_sum(wide(x).sum(dim=(1, 2), keepdim=True))
            se = se / (rows.height * x.shape[2])
        se = swish(self.reduce(se.to(self.dtype)))
        se = self.expand(se)
        gate = torch.sigmoid(wide(se)).to(x.dtype)
        if self.qres == "int8":
            return mul_q8(x, gate, train.mesh if train is not None else None)
        return x * gate


class MBConv(nn.Module):
    """Mobile inverted bottleneck with SE; returns (out, expand_act)."""

    def __init__(self, in_ch: int, out_ch: int, expand: int, kernel: int,
                 stride: int, se_ratio: float = 0.25, drop_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, bn_fold: bool = False,
                 quant=False, qres=None):
        super().__init__()
        self.in_ch, self.out_ch, self.expand = in_ch, out_ch, expand
        self.kernel, self.stride = kernel, stride
        self.drop_rate = drop_rate
        self.dtype = dtype
        self.fold = fold = bn_fold or bool(quant)  # quant graphs are BN-folded
        ce = in_ch * expand
        if expand != 1:
            self.expand_conv = make_conv(quant, dtype, in_ch, ce, 1, bias=fold)
            if not fold:
                self.expand_bn = _bn(ce, qres, dtype, "swish")
        self.dw_conv = make_conv(quant, dtype, ce, ce, kernel, stride=stride, groups=ce,
                                 bias=fold)
        if not fold:
            self.dw_bn = _bn(ce, qres, dtype, "swish")
        self.se = SqueezeExcite(ce, max(1, int(in_ch * se_ratio)), dtype=dtype, qres=qres,
                                 exact_mean=quant == "int8")
        self.project_conv = make_conv(quant, dtype, ce, out_ch, 1, bias=fold)
        if not fold:
            self.project_bn = _bn(out_ch, qres, dtype, None)

    @property
    def residual(self) -> bool:
        return self.stride == 1 and self.in_ch == self.out_ch

    def forward(self, x: torch.Tensor, train: Optional[TrainPass] = None,
                rows: Optional[RowShard] = None):
        """``rows``: x's level; the depthwise conv reads its halo and the
        output is at ``rows.level + 1`` when ``stride`` is 2."""
        dt = self.dtype
        inputs = x
        expand_act = None
        if self.expand != 1:
            x = self.expand_conv(x)
            x = swish(x) if self.fold else _bn_act(self.expand_bn, x, train, dt, "swish")
            expand_act = x  # "blockXa_expand_activation" tap point
        x = self.dw_conv(x) if rows is None else self.dw_conv(x, rows)
        x = swish(x) if self.fold else _bn_act(self.dw_bn, x, train, dt, "swish")
        x = self.se(x, train, None if rows is None else rows.at(rows.level + self.stride - 1))
        x = self.project_conv(x)
        if not self.fold:
            x = _bn_act(self.project_bn, x, train, dt, None)
        if self.residual:
            if train is not None and self.drop_rate > 0:
                # drop-path: one Bernoulli(keep) draw per sample
                keep = 1.0 - self.drop_rate
                draw = batch_rand(train.gen, (x.shape[0],), x.device)
                mask = (draw < keep).reshape(-1, 1, 1, 1)
                x = torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
            x = x + inputs
        return x, expand_act


class EfficientNetEncoder(nn.Module):
    """Returns ``(top, taps)``: the 1/32 top activation and decoder taps
    {"expand_3": 1/4 res, "expand_4": 1/8, "expand_6": 1/16}."""

    def __init__(self, variant: str = "b0", dtype: torch.dtype = torch.bfloat16,
                 drop_connect_rate: float = 0.2, bn_fold: bool = False, quant=False,
                 qres=None):
        super().__init__()
        self.variant, self.dtype = variant, dtype
        self.fold = fold = bn_fold or bool(quant)
        width, depth = VARIANTS[variant]
        total_blocks = sum(round_repeats(r, depth) for (_, _, r, _, _) in _STAGE_DEFS)
        stem_ch = round_filters(32, width)
        self.stem_conv = make_conv(quant, dtype, 3, stem_ch, 3, stride=2, bias=fold)
        if not fold:
            self.stem_bn = _bn(stem_ch, qres, dtype, "swish")
        self.block_names = []
        self.tap_channels: Dict[str, int] = {}
        in_ch = stem_ch
        for stage_num, (expand, ch, repeats, stride, kernel) in enumerate(
            _STAGE_DEFS, start=1
        ):
            out_ch = round_filters(ch, width)
            for i in range(round_repeats(repeats, depth)):
                name = f"stage{stage_num}_block{i}"
                self.add_module(name, MBConv(
                    in_ch, out_ch, expand, kernel, stride if i == 0 else 1,
                    drop_rate=drop_connect_rate * len(self.block_names) / total_blocks,
                    dtype=dtype, bn_fold=bn_fold, quant=quant, qres=qres,
                ))
                self.block_names.append(name)
                if i == 0 and stage_num in DECODER_TAP_STAGES:
                    self.tap_channels[f"expand_{stage_num}"] = in_ch * expand
                in_ch = out_ch
        self.top_ch = round_filters(1280, width)
        self.top_conv = make_conv(quant, dtype, in_ch, self.top_ch, 1, bias=fold)
        if not fold:
            self.top_bn = _bn(self.top_ch, qres, dtype, "swish")

    def _bn_swish(self, x: torch.Tensor, name: str, train: Optional[TrainPass]):
        if self.fold:
            return swish(x)
        return _bn_act(getattr(self, name), x, train, self.dtype, "swish")

    def forward(self, x: torch.Tensor, train: Optional[TrainPass] = None,
                rows: Optional[RowShard] = None):
        if self.fold and train is not None:
            raise ValueError("bn_fold is an inference-only mode (train=False)")
        if rows is None:
            x = self.stem_conv(x.to(self.dtype))
        else:
            x = self.stem_conv(x.to(self.dtype), rows.at(0))
            rows = rows.at(1)
        x = self._bn_swish(x, "stem_bn", train)
        taps: Dict[str, torch.Tensor] = {}
        for name in self.block_names:
            block = getattr(self, name)
            if rows is None:
                x, expand_act = block(x, train)
            else:
                x, expand_act = block(x, train, rows)
                rows = rows.at(rows.level + block.stride - 1)
            stage, i = name[len("stage"):].split("_block")
            if i == "0" and int(stage) in DECODER_TAP_STAGES:
                taps[f"expand_{stage}"] = expand_act
        return self._bn_swish(self.top_conv(x), "top_bn", train), taps

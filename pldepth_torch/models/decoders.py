"""Depth decoders (``pldepth_tpu/models/decoders.py``), dense path.

* :class:`SkipConcatDecoder` (ff_effnet): five conv/BN/ReLU + bilinear-x2
  stages that concatenate the encoder taps at 1/16, 1/8 and 1/4, then a
  1-channel 3x3 head, fused with the last upsample (ops/fused_tail.py) or
  not. ``quant`` makes ``conv0``-``conv4`` int8 sites; the head stays float.
* :class:`ReDWebDecoder` (ff_redweb, the reference's redweb.py:402-434):
  three :class:`FeatureFusion` stages over :class:`ResidualBottleneckPair`
  blocks, then the :class:`AdaptiveOutput` head. Its float graph's convs
  have no bias (``use_bias=fold`` in JAX) except the head's; ``quant``
  makes every conv an int8 site but the head's ``conv1`` and ``conv2``.

``bn_fold=True`` drops the BNs (eps 1e-3) into biased convs
(models/bn_fold.py). With ``pixels`` (B, N, 2) full-resolution (row, col)
both decoders run their last upsample and head only at those pixels
(ops/sparse_tail.py; skip-concat: window 3, the fused tail off; ReDWeb:
window 1) and return (B, N) f32 depths (float64 in a float64 network);
everything before stays dense.

Both decoders run spatially sharded when given ``rows`` (the top's level,
ops/halo.py): every conv, upsample and the fused tail read their halos,
and they return this rank's rows of the depth map; with ``pixels`` too,
each rank scores the pixels it owns from its rows and the scores are
summed over the model ranks (ops/sparse_tail.py), so every model rank
returns the (B, N) scores of the whole map.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from pldepth_torch.core.device import wide
from pldepth_torch.models.layers import Conv, TrainPass
from pldepth_torch.models.quantize import ConvBNScope
from pldepth_torch.ops.conv import conv2d_same_nhwc
from pldepth_torch.ops.fused_tail import fused_upsample2x_head
from pldepth_torch.ops.halo import RowShard, extend_rows
from pldepth_torch.ops.resize import upsample2x_bilinear, upsample_row_plan
from pldepth_torch.ops.sparse_tail import sparse_taps_rows_local, sparse_upsample2x_taps


def _head_at(head: Conv, x: torch.Tensor, pixels: torch.Tensor,
             rows: Optional[RowShard] = None) -> torch.Tensor:
    """``head(upsample2x_bilinear(x))`` at ``pixels`` only, (B, N) f32: the
    head's window of bilinear taps around each pixel, convolved VALID (the
    centre of the JAX package's SAME conv of the patch). With ``rows``
    (x's level), each rank scores the pixels it owns and the scores are
    summed over the model ranks."""
    k = head.weight.shape[-1]
    if rows is None:
        tap = sparse_upsample2x_taps(x, pixels, window=k)  # (B, N, k, k, C)
    else:
        plan = upsample_row_plan(rows)
        tap, owned = sparse_taps_rows_local(extend_rows(x, rows, plan), pixels, k, plan,
                                            rows.index, rows.parts[rows.level - 1][rows.index])
    b, n = tap.shape[:2]
    dt = head.dtype
    y = conv2d_same_nhwc(tap.reshape(b * n, k, k, tap.shape[-1]).to(dt), head.weight.to(dt),
                         padding=0)
    if head.bias is not None:
        y = y + head.bias.to(dt)
    y = wide(y.reshape(b, n))
    if rows is None:
        return y
    return rows.mesh.model_sum(torch.where(owned, y, torch.zeros((), dtype=y.dtype,
                                                                  device=y.device)))


class SkipConcatDecoder(ConvBNScope):
    """(top 1/32, taps expand_6/4/3) -> (B, H, W, 1) f32 depth map."""

    def __init__(self, top_ch: int, tap_channels: Dict[str, int],
                 head_ch: int = 32, dtype: torch.dtype = torch.bfloat16,
                 fused_tail: bool = True, bn_fold: bool = False, quant=False):
        super().__init__(dtype, bn_fold, quant)
        self.fused_tail, self.head_ch = fused_tail, head_ch
        c6, c4, c3 = (tap_channels[f"expand_{s}"] for s in (6, 4, 3))
        ins = (top_ch, 2 * c6, 2 * c4, 2 * c3, head_ch)
        outs = (c6, c4, c3, head_ch, head_ch)
        for idx, (ci, co) in enumerate(zip(ins, outs)):
            self.add_conv(f"conv{idx}", ci, co, 3)
        self.head = Conv(head_ch, 1, 3, dtype=dtype)

    def _conv_bn_relu(self, x: torch.Tensor, idx: int, train: Optional[TrainPass],
                      rows: Optional[RowShard] = None) -> torch.Tensor:
        return torch.relu(self.conv_bn(x, f"conv{idx}", train, rows))

    def forward(self, top: torch.Tensor, taps: Dict[str, torch.Tensor],
                train: Optional[TrainPass] = None,
                pixels: Optional[torch.Tensor] = None,
                rows: Optional[RowShard] = None) -> torch.Tensor:
        if self.fold and train is not None:
            raise ValueError("bn_fold is an inference-only mode (train=False)")

        def at(step):  # the rows ``step`` upsamplings above the top
            return None if rows is None else rows.at(rows.level - step)

        x = top
        for idx, tap in enumerate(("expand_6", "expand_4", "expand_3")):
            x = upsample2x_bilinear(self._conv_bn_relu(x, idx, train, at(idx)), at(idx))
            x = torch.cat([x, taps[tap].to(x.dtype)], dim=-1)
        x = upsample2x_bilinear(self._conv_bn_relu(x, 3, train, at(3)), at(3))  # -> 1/2
        x = self._conv_bn_relu(x.contiguous(), 4, train, at(4))
        if pixels is not None:
            return _head_at(self.head, x, pixels, at(4))
        if self.fused_tail:
            return wide(fused_upsample2x_head(x, self.head.weight, self.head.bias, at(4)))
        return wide(self.head(upsample2x_bilinear(x, at(4)).contiguous(), at(5)))


class ResidualBottleneckPair(ConvBNScope):
    """Two chained residual bottleneck units at constant width ``ch``
    (reference BottleneckConvLayer, redweb.py:67-183)."""

    def __init__(self, ch: int, dtype: torch.dtype = torch.bfloat16, bn_fold: bool = False,
                 quant=False):
        super().__init__(dtype, bn_fold, quant)
        for u in range(2):
            self.add_conv(f"u{u}_conv0", ch, ch // 4, 1, bias=self.fold)
            self.add_conv(f"u{u}_conv1", ch // 4, ch // 4, 3, bias=self.fold)
            self.add_conv(f"u{u}_conv2", ch // 4, ch, 1, bias=self.fold)

    def forward(self, x: torch.Tensor, train: Optional[TrainPass] = None,
                rows: Optional[RowShard] = None) -> torch.Tensor:
        for u in range(2):
            y = torch.relu(self.conv_bn(x, f"u{u}_conv0", train, rows))
            y = torch.relu(self.conv_bn(y, f"u{u}_conv1", train, rows))
            x = torch.relu(self.conv_bn(y, f"u{u}_conv2", train, rows) + x)
        return x


class FeatureFusion(ConvBNScope):
    """Fuse a lateral encoder tap with the upsampled decoder path, then
    upsample x2 (reference FeatureFusionLayer, redweb.py:225-290)."""

    def __init__(self, ch: int, lateral_ch: int, up_ch: int,
                 dtype: torch.dtype = torch.bfloat16, bn_fold: bool = False, quant=False):
        super().__init__(dtype, bn_fold, quant)
        self.add_conv("lateral_conv", lateral_ch, ch, 3, bias=self.fold)
        self.lateral_block = ResidualBottleneckPair(ch, dtype, bn_fold, quant)
        self.add_conv("up_conv", up_ch, ch, 3, bias=self.fold)
        self.fuse_block = ResidualBottleneckPair(ch, dtype, bn_fold, quant)

    def forward(self, lateral: torch.Tensor, up: torch.Tensor,
                train: Optional[TrainPass] = None,
                rows: Optional[RowShard] = None) -> torch.Tensor:
        """``rows``: the inputs' level; the result is at the level above."""
        left = self.lateral_block(self.conv_bn(lateral, "lateral_conv", train, rows), train,
                                  rows)
        x = left + self.conv_bn(up, "up_conv", train, rows)
        return upsample2x_bilinear(self.fuse_block(x, train, rows), rows)


class AdaptiveOutput(ConvBNScope):
    """Depth head (reference AdaptiveOutputLayer, redweb.py:293-351): 3x3
    conv (biased) + BN + ReLU, a 3x3 conv to one channel, bilinear x2, a
    1x1 conv. ``conv1`` and ``conv2`` stay float in the int8 graph."""

    def __init__(self, in_ch: int, dtype: torch.dtype = torch.bfloat16,
                 bn_fold: bool = False, quant=False):
        super().__init__(dtype, bn_fold, quant)
        self.add_conv("conv0", in_ch, 64, 3)
        self.conv1 = Conv(64, 1, 3, dtype=dtype)
        self.conv2 = Conv(1, 1, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, train: Optional[TrainPass] = None,
                pixels: Optional[torch.Tensor] = None,
                rows: Optional[RowShard] = None) -> torch.Tensor:
        x = self.conv1(torch.relu(self.conv_bn(x, "conv0", train, rows)), rows)
        if pixels is not None:
            return _head_at(self.conv2, x, pixels, rows)
        up = None if rows is None else rows.at(rows.level - 1)
        return wide(self.conv2(upsample2x_bilinear(x, rows).contiguous(), up))


class ReDWebDecoder(nn.Module):
    """(c5 1/32, taps c4_mid/c3/c2) -> (B, H, W, 1) f32 depth map."""

    TAPS = ("c4_mid", "c3", "c2")

    def __init__(self, top_ch: int, tap_channels: Dict[str, int],
                 fusion_ch: Sequence[int] = (256, 128, 64),
                 dtype: torch.dtype = torch.bfloat16, bn_fold: bool = False, quant=False):
        super().__init__()
        self.fold = bn_fold or bool(quant)
        up_ch = top_ch
        for i, (tap, ch) in enumerate(zip(self.TAPS, fusion_ch)):
            self.add_module(f"fusion{i}", FeatureFusion(ch, tap_channels[tap], up_ch, dtype,
                                                        bn_fold, quant))
            up_ch = ch
        self.output = AdaptiveOutput(up_ch, dtype, bn_fold, quant)

    def forward(self, c5: torch.Tensor, taps: Dict[str, torch.Tensor],
                train: Optional[TrainPass] = None, pixels=None,
                rows: Optional[RowShard] = None) -> torch.Tensor:
        if self.fold and train is not None:
            raise ValueError("bn_fold is an inference-only mode (train=False)")

        def at(step):  # the rows ``step`` upsamplings above c5
            return None if rows is None else rows.at(rows.level - step)

        x = upsample2x_bilinear(c5, at(0))  # 1/32 -> 1/16
        for i, tap in enumerate(self.TAPS):  # 1/16 -> 1/8 -> 1/4 -> 1/2
            x = getattr(self, f"fusion{i}")(taps[tap], x, train, at(i + 1))
        return self.output(x, train, pixels, at(4))  # -> 1/1

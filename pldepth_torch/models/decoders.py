"""Skip-concat depth decoder (``pldepth_tpu/models/decoders.py:
SkipConcatDecoder``), dense path: five conv/BN/ReLU + bilinear-x2 stages
that concatenate the encoder taps at 1/16, 1/8 and 1/4, then a 1-channel
3x3 head, fused with the last upsample (ops/fused_tail.py) or not. The
sparse ``pixels`` tail and ``ReDWebDecoder`` come with later slices
(ROADMAP.md queue 1 items 6 and 9). ``bn_fold=True`` drops the BNs into
biased convs; ``quant`` makes ``conv0``-``conv4`` int8 sites
(models/quantize.py); the head stays float in every mode.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from pldepth_torch.models.layers import BatchNorm, Conv, TrainPass
from pldepth_torch.models.quantize import make_conv
from pldepth_torch.ops.fused_tail import fused_upsample2x_head
from pldepth_torch.ops.resize import upsample2x_bilinear


class SkipConcatDecoder(nn.Module):
    """(top 1/32, taps expand_6/4/3) -> (B, H, W, 1) f32 depth map."""

    def __init__(self, top_ch: int, tap_channels: Dict[str, int],
                 head_ch: int = 32, dtype: torch.dtype = torch.bfloat16,
                 fused_tail: bool = True, bn_fold: bool = False, quant=False):
        super().__init__()
        self.dtype, self.fused_tail, self.head_ch = dtype, fused_tail, head_ch
        self.fold = bn_fold or bool(quant)
        c6, c4, c3 = (tap_channels[f"expand_{s}"] for s in (6, 4, 3))
        ins = (top_ch, 2 * c6, 2 * c4, 2 * c3, head_ch)
        outs = (c6, c4, c3, head_ch, head_ch)
        for idx, (ci, co) in enumerate(zip(ins, outs)):
            self.add_module(f"conv{idx}", make_conv(quant, dtype, ci, co, 3))
            if not self.fold:
                self.add_module(f"bn{idx}", BatchNorm(co))
        self.head = Conv(head_ch, 1, 3, dtype=dtype)

    def _conv_bn_relu(self, x: torch.Tensor, idx: int,
                      train: Optional[TrainPass]) -> torch.Tensor:
        x = getattr(self, f"conv{idx}")(x)
        if not self.fold:
            x = getattr(self, f"bn{idx}")(x, train).to(self.dtype)
        return torch.relu(x)

    def forward(self, top: torch.Tensor, taps: Dict[str, torch.Tensor],
                train: Optional[TrainPass] = None) -> torch.Tensor:
        if self.fold and train is not None:
            raise ValueError("bn_fold is an inference-only mode (train=False)")
        x = top
        for idx, tap in enumerate(("expand_6", "expand_4", "expand_3")):
            x = upsample2x_bilinear(self._conv_bn_relu(x, idx, train))
            x = torch.cat([x, taps[tap].to(x.dtype)], dim=-1)
        x = upsample2x_bilinear(self._conv_bn_relu(x, 3, train))  # -> 1/2
        x = self._conv_bn_relu(x.contiguous(), 4, train)
        if self.fused_tail:
            return fused_upsample2x_head(x, self.head.weight, self.head.bias).to(torch.float32)
        return self.head(upsample2x_bilinear(x).contiguous()).to(torch.float32)

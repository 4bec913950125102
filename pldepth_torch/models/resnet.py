"""ResNet-50 encoder with the ReDWeb decoder's feature taps.

Port of ``pldepth_tpu/models/resnet.py`` (the reference's
``keras.applications.ResNet50``, pldepth/models/redweb.py:409-421): NHWC
tensors, f32 parameters cast to the compute dtype at use, f32 batch-norm.
Keras-v1 conventions, each of which a test holds:

* BN epsilon 1.001e-5 (the decoder's is 1e-3); ``bn_fold.fold_module``
  folds with each BatchNorm's own eps;
* the stem is a 7x7 stride-2 conv with explicit (3, 3) padding, not SAME,
  then ReLU and a 3x3 stride-2 max pool padded by 1;
* the stride 2 of a downsampling block sits on its first 1x1 conv (and on
  its projection);
* every conv carries a bias.

Submodule names are the flax ones (``stem_conv``, ``stage2_block0.conv1``,
``stage3_block0.proj_bn`` ...), so models/pretrained.py maps weights by name
alone. ``stage_blocks`` and ``c4_tap_block`` cut the depth for tests.
``bn_fold=True`` builds the BN-folded inference graph, ``quant`` the int8
one (models/quantize.py): every conv is a dense int8 site.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from pldepth_torch.models.layers import TrainPass
from pldepth_torch.models.quantize import ConvBNScope

BN_EPS = 1.001e-5
FILTERS = (64, 128, 256, 512)
# channels of the decoder taps and of the 1/32 output
TAP_CHANNELS = {"c2": 256, "c3": 512, "c4_mid": 1024}
TOP_CH = 2048


class Bottleneck(ConvBNScope):
    """1x1 -> 3x3 -> 1x1 (4 * filters out), BN + ReLU after each, the
    shortcut projected where the shape changes; relu(y + shortcut)."""

    def __init__(self, in_ch: int, filters: int, stride: int = 1, projection: bool = False,
                 dtype: torch.dtype = torch.bfloat16, bn_fold: bool = False, quant=False):
        super().__init__(dtype, bn_fold, quant, bn_eps=BN_EPS)
        self.projection = projection
        out_ch = 4 * filters
        if projection:
            self.add_conv("proj_conv", in_ch, out_ch, 1, stride=stride)
        self.add_conv("conv1", in_ch, filters, 1, stride=stride)
        self.add_conv("conv2", filters, filters, 3)
        self.add_conv("conv3", filters, out_ch, 1)

    def forward(self, x: torch.Tensor, train: Optional[TrainPass] = None) -> torch.Tensor:
        shortcut = self.conv_bn(x, "proj_conv", train) if self.projection else x
        y = torch.relu(self.conv_bn(x, "conv1", train))
        y = torch.relu(self.conv_bn(y, "conv2", train))
        return torch.relu(self.conv_bn(y, "conv3", train) + shortcut)


class ResNet50Encoder(ConvBNScope):
    """Returns ``(c5, taps)`` with taps {"c2": 1/4, "c3": 1/8, "c4_mid":
    1/16}; ``c4_mid`` is the output of block ``c4_tap_block`` of stage 4
    (the reference taps conv4_block3_out, index 2)."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 stage_blocks: Sequence[int] = (3, 4, 6, 3), c4_tap_block: int = 2,
                 bn_fold: bool = False, quant=False):
        super().__init__(dtype, bn_fold, quant, bn_eps=BN_EPS)
        self.c4_tap_block = c4_tap_block
        self.add_conv("stem_conv", 3, 64, 7, stride=2, padding=3)
        self.stage_blocks = tuple(stage_blocks)
        in_ch = 64
        for stage, blocks in enumerate(self.stage_blocks):
            for i in range(blocks):
                self.add_module(f"stage{stage + 2}_block{i}", Bottleneck(
                    in_ch, FILTERS[stage], stride=2 if (i == 0 and stage > 0) else 1,
                    projection=(i == 0), dtype=dtype, bn_fold=bn_fold, quant=quant))
                in_ch = 4 * FILTERS[stage]

    def forward(self, x: torch.Tensor, train: Optional[TrainPass] = None):
        if self.fold and train is not None:
            raise ValueError("bn_fold is an inference-only mode (train=False)")
        x = torch.relu(self.conv_bn(x.to(self.dtype), "stem_conv", train))
        # 3x3 stride-2 max pool, padded by 1 with -inf (flax nn.max_pool)
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        taps: Dict[str, torch.Tensor] = {}
        for stage, blocks in enumerate(self.stage_blocks, start=2):
            for i in range(blocks):
                x = getattr(self, f"stage{stage}_block{i}")(x, train)
                if stage == 4 and i == self.c4_tap_block:
                    taps["c4_mid"] = x
            if stage in (2, 3):
                taps[f"c{stage}"] = x
        return x, taps

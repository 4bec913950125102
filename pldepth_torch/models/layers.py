"""Flax-equivalent building blocks on NHWC tensors.

``Conv`` is ``flax.linen.Conv(padding='SAME')``: TF SAME padding (asymmetric
at stride 2), input and kernel cast to the compute dtype at use, bias added
in the compute dtype. ``BatchNorm`` is flax ``BatchNorm(dtype=float32,
epsilon=1e-3)`` with running statistics: ``(x - mean) * (rsqrt(var + eps) *
scale) + bias`` in f32. Parameters stay f32; weights are OIHW, the layout
``F.conv2d`` takes (models/pretrained.py maps them to and from flax HWIO).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from pldepth_torch.ops.conv import conv2d_same_nhwc
from pldepth_torch.ops.fused_mbconv import fold_bn


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default conv init: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        t.normal_(0.0, std, generator=generator).clamp_(-2 * std, 2 * std)


class Conv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.stride, self.groups, self.dtype = stride, groups, dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight[0].numel()
        lecun_normal_(self.weight, fan_in, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = conv2d_same_nhwc(x.to(dt), self.weight.to(dt), self.stride, self.groups)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class BatchNorm(nn.Module):
    """Inference BatchNorm (running statistics); returns f32."""

    def __init__(self, ch: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(torch.float32) - self.running_mean
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return y * mul + self.bias

    def folded(self):
        """(scale, shift) of the affine this BN applies."""
        return fold_bn(self.weight, self.bias, self.running_mean,
                       self.running_var, self.eps)


def reset_parameters(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every Conv / BatchNorm below ``module`` in module order."""
    for m in module.modules():
        if isinstance(m, (Conv, BatchNorm)):
            m.reset_parameters(generator)
    return module

"""Flax-equivalent building blocks on NHWC tensors.

``Conv`` is ``flax.linen.Conv(padding='SAME')``: TF SAME padding (asymmetric
at stride 2) or an explicit symmetric ``padding``, input and kernel cast to
the compute dtype at use, bias added in the compute dtype. ``BatchNorm`` is
flax ``BatchNorm(dtype=float32, epsilon=1e-3)`` (the ResNet encoder builds
its own with 1.001e-5) with running statistics: ``(x - mean) * (rsqrt(var + eps) *
scale) + bias`` in f32. Parameters stay f32; weights are OIHW, the layout
``F.conv2d`` takes (models/pretrained.py maps them to and from flax HWIO).

A module runs in train mode when its forward is given a :class:`TrainPass`:
batch-norm then normalises with batch statistics and puts its new running
statistics into the pass instead of changing its buffers (flax's
``mutable=["batch_stats"]``), so the trainer can commit them or keep the
old ones (the finite guard, train/trainer.py). Under data parallelism
the pass carries the process's mesh (core/mesh.py) and the statistics are
those of the global batch (:func:`batch_moments`); under spatial sharding
too, whose ranks each hold some rows of the batch's images (a rank with no
rows adds zeros and a zero count). A float64 network keeps its statistics
in float64 (core/device.py ``wide``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from pldepth_torch.core.device import wide
from pldepth_torch.ops.conv import conv2d_same_nhwc
from pldepth_torch.ops.fused_mbconv import fold_bn
from pldepth_torch.ops.halo import RowShard


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
                 dtype: torch.dtype = torch.bfloat16, padding: Optional[int] = None):
        super().__init__()
        self.stride, self.groups, self.dtype = stride, groups, dtype
        self.padding = padding  # None: SAME; else explicit, every side
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight[0].numel()
        lecun_normal_(self.weight, fan_in, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, rows: Optional[RowShard] = None) -> torch.Tensor:
        """``rows``: x holds this rank's image rows (spatial sharding,
        ops/halo.py), and so does the result."""
        dt = self.dtype
        y = conv2d_same_nhwc(x.to(dt), self.weight.to(dt), self.stride, self.groups,
                             self.padding, rows)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


@dataclasses.dataclass
class TrainPass:
    """One train-mode forward: the generator of its drop-path draws (on the
    activations' device; a ``core.mesh.RowsGenerator`` in the train step),
    the new BN running statistics it makes, {BatchNorm module: (mean,
    var)}, and the mesh whose ranks share the batch (None: one process)."""

    gen: Optional[object] = None
    new_stats: Dict[nn.Module, Tuple[torch.Tensor, torch.Tensor]] = dataclasses.field(
        default_factory=dict)
    mesh: Optional[object] = None


def per_count(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``total / count`` as the device's own ``mean`` forms it: CUDA
    multiplies the sum by the f32 reciprocal, the CPU divides. A world of
    one then gives ``mean``'s bits exactly."""
    return total * torch.reciprocal(count) if total.is_cuda else total / count


def batch_moments(x: torch.Tensor, mesh=None):
    """(mean, x - mean, biased variance) of f32 ``x`` over every axis but
    the last, by two passes. With a mesh that has a process group they are
    the global batch's: the local sums and the row count are all-reduced,
    then the local sums of squared deviations (differentiable all-reduces,
    so the backward is SyncBN's)."""
    dims = tuple(range(x.dim() - 1))
    if mesh is None or not mesh.active:
        mean = x.mean(dim=dims)
        y = x - mean
        return mean, y, torch.square(y).mean(dim=dims)
    c = x.shape[-1]
    sums = mesh.sum(torch.cat([x.sum(dim=dims), x.new_full((1,), x.numel() // c)]))
    count = sums[c]
    mean = per_count(sums[:c], count)
    y = x - mean
    return mean, y, per_count(mesh.sum(torch.square(y).sum(dim=dims)), count)


class BatchNorm(nn.Module):
    """flax ``BatchNorm(momentum=0.99, epsilon=1e-3, dtype=float32,
    use_fast_variance=False)``; returns f32. Inference uses the running
    statistics. Train mode uses the batch's mean and two-pass biased
    variance over (B, H, W) (the global batch's under a process group),
    computed in f32, and puts
    ``momentum * running + (1 - momentum) * batch`` into ``train.new_stats``
    (the buffers are left as they are)."""

    def __init__(self, ch: int, eps: float = 1e-3, momentum: float = 0.99):
        super().__init__()
        self.eps, self.momentum = eps, momentum
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

    def forward(self, x: torch.Tensor, train: Optional[TrainPass] = None) -> torch.Tensor:
        x = wide(x)
        if train is None:
            y, var = x - self.running_mean, self.running_var
        else:
            mean, y, var = batch_moments(x, train.mesh)
            with torch.no_grad():
                m = self.momentum
                train.new_stats[self] = (m * self.running_mean + (1 - m) * mean,
                                         m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
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

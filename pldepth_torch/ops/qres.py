"""Train-mode BatchNorm(+swish) with a compressed backward residual
(``pldepth_tpu/ops/qres.py``, ``--qres int8|bf16``).

:func:`bn_act_train` is the encoder's conv-following ``BN -> swish`` pair
as one autograd unit whose only large saved tensor is the normalised
activation x̂, stored compressed:

* ``store="int8"``: per-tensor symmetric int8, ``r = clip(round(x̂ * (127
  / amax)), -127, 127)`` (round half to even) with ``amax = max(max|x̂|,
  1e-12)``, read back as ``r * amax / 127``; one byte an element;
* ``store="bf16"``: x̂ in bf16; two bytes an element.

The forward is bit-identical to the standard path (models/layers.py
``BatchNorm`` with its two-pass f32 statistics, cast to the compute dtype,
then swish): the compression changes what the backward reads, nothing
else. The backward rebuilds ``y = scale * x̂ + bias`` (rounded to the
compute dtype, as the forward activated it) and applies the BN + swish
VJP in f32. :func:`mul_q8` is the squeeze-excite multiply whose backward
reads its full-size input from int8 (``qres="int8"`` only). These are
plain PyTorch: the JAX package has no Pallas kernel here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pldepth_torch.models.layers import BatchNorm, TrainPass, swish

STORES = ("int8", "bf16")


def _apply_act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act == "swish":
        return swish(y)
    if act is None:
        return y
    raise ValueError(f"unknown act {act!r}")


def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 r, f32 scale): symmetric per-tensor int8 of f32 ``x``."""
    amax = torch.clamp(x.abs().amax(), min=1e-12)
    q = torch.round(x * (torch.full_like(amax, 127.0) / amax))
    return torch.clamp(q, -127, 127).to(torch.int8), amax / 127.0


class BnActTrain(torch.autograd.Function):
    """(x, scale, bias) -> (z, mean, var); see :func:`bn_act_train`."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, act: Optional[str], store: str,
                out_dtype: torch.dtype):
        if store not in STORES:
            raise ValueError(f"unknown store {store!r}")
        xf = x.to(torch.float32)
        dims = tuple(range(x.dim() - 1))
        mean = xf.mean(dim=dims)
        y = xf - mean
        var = torch.square(y).mean(dim=dims)
        inv = torch.rsqrt(var + eps)
        z = _apply_act((y * (inv * scale) + bias).to(out_dtype), act)
        xhat = y * inv
        if store == "int8":
            r, r_scale = _q8(xhat)
        else:
            r, r_scale = xhat.to(torch.bfloat16), torch.ones((), device=x.device)
        ctx.save_for_backward(r, r_scale, inv, scale, bias)
        ctx.act, ctx.out_dtype, ctx.x_dtype = act, out_dtype, x.dtype
        ctx.mark_non_differentiable(mean, var)
        return z, mean, var

    @staticmethod
    def backward(ctx, gz, g_mean, g_var):
        r, r_scale, inv, scale, bias = ctx.saved_tensors
        xhat = r.to(torch.float32) * r_scale
        if ctx.act == "swish":
            y = (xhat * scale + bias).to(ctx.out_dtype).to(torch.float32)
            s = torch.sigmoid(y)
            dy = gz.to(torch.float32) * (s + y * s * (1.0 - s))
        else:
            dy = gz.to(torch.float32)
        dims = tuple(range(dy.dim() - 1))
        n = dy.numel() // dy.shape[-1]
        sum_dy = dy.sum(dim=dims)
        sum_dy_xhat = (dy * xhat).sum(dim=dims)
        dx = (scale * inv) * (dy - sum_dy / n - xhat * (sum_dy_xhat / n))
        return dx.to(ctx.x_dtype), sum_dy_xhat, sum_dy, None, None, None, None


def bn_act_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
                 act: Optional[str], store: str, out_dtype: torch.dtype):
    """Train-mode BN over (B, H, W) of NHWC ``x`` with affine (scale, bias),
    then ``act`` ("swish" or None) in ``out_dtype``; returns (z, batch mean,
    biased batch variance), the statistics without gradient. The backward
    reads x̂ from its ``store`` ("int8" or "bf16") compression."""
    return BnActTrain.apply(x, scale, bias, eps, act, store, out_dtype)


class MulQ8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, gate):
        r, r_scale = _q8(z.to(torch.float32))
        ctx.save_for_backward(r, r_scale, gate)
        ctx.z_dtype = z.dtype
        return z * gate

    @staticmethod
    def backward(ctx, go):
        r, r_scale, gate = ctx.saved_tensors
        zq = (r.to(torch.float32) * r_scale).to(ctx.z_dtype)
        dgate = (go * zq).to(torch.float32).sum(dim=(1, 2), keepdim=True).to(gate.dtype)
        return go * gate, dgate


def mul_q8(z: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """``z * gate`` (the SE excitation, ``gate`` (B, 1, 1, C)) whose backward
    reads ``z`` from a per-tensor int8 copy."""
    return MulQ8.apply(z, gate)


class FusedBNAct(BatchNorm):
    """A :class:`BatchNorm` (same parameters and buffers, so checkpoints and
    the BN fold are those of the standard path) that also applies ``act``
    and returns ``out_dtype``. Train mode goes through :func:`bn_act_train`
    and puts the new running statistics into the pass; inference is the
    running-statistics normalise, as ``BatchNorm``."""

    def __init__(self, ch: int, act: Optional[str] = "swish", store: str = "int8",
                 out_dtype: torch.dtype = torch.bfloat16, eps: float = 1e-3,
                 momentum: float = 0.99):
        super().__init__(ch, eps=eps, momentum=momentum)
        if store not in STORES:
            raise ValueError(f"unknown store {store!r}")
        self.act, self.store, self.out_dtype = act, store, out_dtype

    def forward(self, x: torch.Tensor, train: Optional[TrainPass] = None) -> torch.Tensor:
        if train is None:
            return _apply_act(super().forward(x).to(self.out_dtype), self.act)
        z, mean, var = bn_act_train(x, self.weight, self.bias, self.eps, self.act,
                                    self.store, self.out_dtype)
        with torch.no_grad():
            m = self.momentum
            train.new_stats[self] = (m * self.running_mean + (1 - m) * mean,
                                     m * self.running_var + (1 - m) * var)
        return z

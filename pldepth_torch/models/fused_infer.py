"""Serving-path EfficientNet encoder on the fused MBConv kernel (K2).

Port of ``pldepth_tpu/models/fused_infer.py``. The JAX planner screens each
block against a VMEM budget and probe-compiles it, because the TPU kernel
holds a whole expanded image on chip. K2 on the card tiles its work
(ops/fused_mbconv.py) and takes every block shape, so there is no budget and
no probe: every MBConv block launches K2.

The tap rule stays: the first block of stages 3, 4 and 6 emits its expand
activation for the decoder. Such a block runs in two parts, as
``_xla_block_with_tap`` does: its expand (1x1 conv + BN + swish) in torch,
which yields the tap, then K2 in its expand==1 form on the tap for the rest
of the block. One B0 forward therefore launches K2 16 times. The stem conv
and the top conv stay torch convolutions.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from pldepth_torch.models.efficientnet import (
    DECODER_TAP_STAGES,
    EfficientNetEncoder,
    MBConv,
)
from pldepth_torch.models.layers import swish
from pldepth_torch.ops.conv import conv2d_same_nhwc, same_out_and_pad
from pldepth_torch.ops.fused_mbconv import MBConvParams, cast_params, fused_mbconv_infer


class BlockPlan(NamedTuple):
    name: str
    params: MBConvParams  # folded, cast to the serving dtype
    kernel: int
    stride: int
    residual: bool
    fused: bool  # K2 runs the whole block (False: tap block, K2 runs its tail)
    tap: Optional[str]  # taps dict key if this block emits its expand activation
    in_hw: Tuple[int, int]  # block input size at the planned input size


def _mat(conv) -> torch.Tensor:
    """1x1 conv weight (out, in, 1, 1) -> (in, out) matrix."""
    return conv.weight[:, :, 0, 0].t()


def extract_block_params(blk: MBConv) -> MBConvParams:
    """Fold one MBConv block's weights and running stats into K2's f32
    inference bundle (detached from autograd)."""
    with torch.no_grad():
        if blk.expand != 1:
            we = _mat(blk.expand_conv)
            e_scale, e_shift = blk.expand_bn.folded()
        else:
            we = e_scale = e_shift = None
        dw = blk.dw_conv.weight[:, 0].permute(1, 2, 0)  # (Ce,1,k,k) -> (k,k,Ce)
        d_scale, d_shift = blk.dw_bn.folded()
        p_scale, p_shift = blk.project_bn.folded()
        p = MBConvParams(
            we=we, e_scale=e_scale, e_shift=e_shift,
            dw=dw, d_scale=d_scale, d_shift=d_shift,
            se_w1=_mat(blk.se.reduce), se_b1=blk.se.reduce.bias,
            se_w2=_mat(blk.se.expand), se_b2=blk.se.expand.bias,
            wp=_mat(blk.project_conv), p_scale=p_scale, p_shift=p_shift,
        )
    return MBConvParams(*[None if v is None else v.detach() for v in p])


def plan_encoder(encoder: EfficientNetEncoder, input_hw: Tuple[int, int],
                 dtype: Optional[torch.dtype] = None) -> List[BlockPlan]:
    """Static per-block plan for one input size, with each block's folded
    parameters cast once to the serving dtype (default: the encoder's)."""
    dtype = dtype or encoder.dtype
    h = same_out_and_pad(input_hw[0], 3, 2)[0]  # after the stride-2 stem
    w = same_out_and_pad(input_hw[1], 3, 2)[0]
    plans: List[BlockPlan] = []
    for name in encoder.block_names:
        blk: MBConv = getattr(encoder, name)
        stage, i = name[len("stage"):].split("_block")
        tap = (f"expand_{stage}"
               if i == "0" and int(stage) in DECODER_TAP_STAGES else None)
        plans.append(BlockPlan(
            name=name,
            params=cast_params(extract_block_params(blk), dtype),
            kernel=blk.kernel,
            stride=blk.stride,
            residual=blk.residual,
            fused=tap is None,
            tap=tap,
            in_hw=(h, w),
        ))
        h, w = -(-h // blk.stride), -(-w // blk.stride)  # SAME: ceil
    return plans


def _conv_bn_swish(x, weight, scale, shift, stride: int):
    dt = x.dtype
    y = conv2d_same_nhwc(x, weight.to(dt), stride)
    y = (y.to(torch.float32) * scale + shift).to(dt)
    return swish(y)


def _block_with_tap(x: torch.Tensor, p: MBConvParams, *, kernel, stride, residual):
    """Tap block: expand (1x1 conv + BN + swish) in torch, which is the tap,
    then K2 in its expand==1 form on it."""
    dt = x.dtype
    h = torch.matmul(x, p.we.to(dt))  # the 1x1 conv as a product over NHWC
    h = swish((h.to(torch.float32) * p.e_scale + p.e_shift).to(dt))
    tail = p._replace(we=None, e_scale=None, e_shift=None)
    y = fused_mbconv_infer(h, tail, kernel=kernel, stride=stride, residual=False)
    if residual:
        y = y + x
    return y, h


def encoder_infer(encoder: EfficientNetEncoder, x: torch.Tensor,
                  plans: List[BlockPlan], dtype: Optional[torch.dtype] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Inference encoder forward on K2. Returns (top, taps) like
    ``EfficientNetEncoder.forward`` for a model computing in ``dtype``."""
    dtype = dtype or encoder.dtype
    x = x.to(dtype)
    s, t = encoder.stem_bn.folded()
    x = _conv_bn_swish(x, encoder.stem_conv.weight, s, t, 2).contiguous()
    taps: Dict[str, torch.Tensor] = {}
    for plan in plans:
        if plan.tap is not None:
            x, taps[plan.tap] = _block_with_tap(
                x, plan.params, kernel=plan.kernel, stride=plan.stride,
                residual=plan.residual,
            )
        else:
            x = fused_mbconv_infer(
                x, plan.params, kernel=plan.kernel, stride=plan.stride,
                residual=plan.residual,
            )
    s, t = encoder.top_bn.folded()
    return _conv_bn_swish(x, encoder.top_conv.weight, s, t, 1), taps

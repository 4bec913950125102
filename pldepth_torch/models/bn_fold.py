"""Inference batch-norm folding (``pldepth_tpu/models/bn_fold.py``).

Every ``conv -> BatchNorm`` pair collapses into one biased conv for
serving: with running statistics (mean, var) and affine (scale, beta),

    BN(conv(x; W, b)) = conv(x; W * s, s * (b - mean) + beta),
    s = scale / sqrt(var + eps)   (per output channel, f32).

Pairing rule: a BatchNorm named ``X`` normalises the sibling conv named
``X.replace("bn", "conv")`` (``stage2_block0.dw_bn`` -> ``dw_conv``,
``decoder.bn3`` -> ``conv3``). Each BatchNorm folds with its own ``eps``,
which gives the JAX package's per-scope rule (1e-3, and 1.001e-5 for the
ResNet encoder of ``ff_redweb``, models/resnet.py). The model
classes take ``bn_fold=True`` for the folded graph (no BN modules, biased
convs), inference only.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

from pldepth_torch.models.layers import BatchNorm

_STATS = (".running_mean", ".running_var")


def fold_state_dict(sd: Mapping[str, torch.Tensor],
                    eps: Mapping[str, float]) -> Dict[str, torch.Tensor]:
    """A model's ``state_dict`` -> the ``state_dict`` of its ``bn_fold=True``
    twin; ``eps`` is {BatchNorm name: eps}. Tensors that are not part of a
    conv -> BN pair pass through as they are."""
    bns = sorted(k[: -len(_STATS[0])] for k in sd if k.endswith(_STATS[0]))
    if not bns:
        raise ValueError("bn fold needs BatchNorm running statistics "
                         "(running_mean / running_var), found none")
    out = {k: v for k, v in sd.items()
           if not any(k.startswith(bn + ".") for bn in bns)}
    for bn in bns:
        path, _, leaf = bn.rpartition(".")
        conv_leaf = leaf.replace("bn", "conv")
        conv = f"{path}.{conv_leaf}" if path else conv_leaf
        if conv_leaf == leaf or f"{conv}.weight" not in sd:
            raise ValueError(f"BatchNorm {bn!r} has no sibling conv {conv!r}")
        f32 = lambda name: sd[name].to(torch.float32)  # noqa: E731
        s = f32(f"{bn}.weight") / torch.sqrt(f32(f"{bn}.running_var") + eps[bn])
        w = f32(f"{conv}.weight")
        b = f32(f"{conv}.bias") if f"{conv}.bias" in sd else torch.zeros_like(s)
        # OIHW: the output channel leads (depthwise (C, 1, k, k) too)
        out[f"{conv}.weight"] = w * s.reshape(-1, 1, 1, 1)
        out[f"{conv}.bias"] = s * (b - f32(f"{bn}.running_mean")) + f32(f"{bn}.bias")
    return out


def fold_module(module: nn.Module) -> Dict[str, torch.Tensor]:
    """:func:`fold_state_dict` of ``module`` with each BatchNorm's own eps;
    the folded tensors are detached and on the module's device."""
    eps = {name: m.eps for name, m in module.named_modules() if isinstance(m, BatchNorm)}
    with torch.no_grad():
        return fold_state_dict({k: v.detach() for k, v in module.state_dict().items()}, eps)

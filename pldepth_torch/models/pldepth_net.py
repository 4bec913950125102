"""Model factory (``pldepth_tpu/models/pldepth_net.py``): the ff_effnet
family, EfficientNet encoder + skip-concat decoder, NHWC in and out.

A :class:`PLDepthModel` names a model and knows how to build a fresh
``nn.Module`` for it; ``init_module`` initialises one from a
``torch.Generator`` on a device. The weights live in the module, which the
trainer's state holds.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
from torch import nn

from pldepth_torch.core.device import torch_dtype
from pldepth_torch.models.decoders import SkipConcatDecoder
from pldepth_torch.models.efficientnet import VARIANTS, EfficientNetEncoder
from pldepth_torch.models.layers import reset_parameters


class EffNetFullyFledged(nn.Module):
    """EfficientNet encoder + skip-concat decoder -> (B, H, W, 1) f32 depth
    (descending depth order, as the HR-WSI convention of the reference)."""

    def __init__(self, variant: str = "b0", dtype: torch.dtype = torch.bfloat16,
                 fused_tail: bool = True, head_ch: int = 32):
        super().__init__()
        self.variant, self.dtype = variant, dtype
        self.fused_tail, self.head_ch = fused_tail, head_ch
        self.encoder = EfficientNetEncoder(variant, dtype=dtype)
        self.decoder = SkipConcatDecoder(
            self.encoder.top_ch, self.encoder.tap_channels, head_ch=head_ch,
            dtype=dtype, fused_tail=fused_tail,
        )

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        top, taps = self.encoder(x, train)
        return self.decoder(top, taps, train)


@dataclasses.dataclass(frozen=True)
class PLDepthModel:
    name: str
    make: Callable[[], nn.Module]  # builds the architecture, weights unset
    preprocess: str  # normalization family for data/preprocess.py

    def init_module(self, generator: torch.Generator,
                    device: torch.device | str = "cpu") -> nn.Module:
        """A fresh module, initialised from ``generator`` (on the CPU, so the
        values do not depend on the device), moved to ``device``, eval mode."""
        module = reset_parameters(self.make(), generator)
        return module.to(device).eval()


def _effnet(name: str, variant: str):
    def factory(dtype=torch.bfloat16, fused_tail=True, head_ch=32) -> PLDepthModel:
        return PLDepthModel(
            name,
            lambda: EffNetFullyFledged(variant, dtype, fused_tail, head_ch),
            "effnet",
        )
    return factory


def _redweb(dtype=torch.bfloat16, fused_tail=True, head_ch=32) -> PLDepthModel:
    raise NotImplementedError(
        "ff_redweb (ResNet-50 + ReDWeb decoder) is not ported yet: "
        "ROADMAP.md queue 1 item 9")


MODEL_REGISTRY: Dict[str, Callable[..., PLDepthModel]] = {
    "ff_effnet": _effnet("ff_effnet", "b0"),
    "ff_smoke": _effnet("ff_smoke", "smoke"),
    "ff_redweb": _redweb,
}
for _v in VARIANTS:
    if _v not in ("b0", "smoke"):
        MODEL_REGISTRY[f"ff_effnet_{_v}"] = _effnet(f"ff_effnet_{_v}", _v)


def get_model_type_by_name(model_name: str) -> str:
    if model_name not in MODEL_REGISTRY:
        raise ValueError(
            f"Unknown model name: {model_name} (have {sorted(MODEL_REGISTRY)})"
        )
    return model_name


def get_pl_depth_net(model_name: str, compute_dtype: str = "bfloat16",
                     fused_tail: bool = True, head_ch: int = 32) -> PLDepthModel:
    get_model_type_by_name(model_name)
    return MODEL_REGISTRY[model_name](
        dtype=torch_dtype(compute_dtype), fused_tail=fused_tail, head_ch=head_ch,
    )

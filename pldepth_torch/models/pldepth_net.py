"""Model factory (``pldepth_tpu/models/pldepth_net.py``): the ff_effnet
family (EfficientNet encoder + skip-concat decoder) and ff_redweb (ResNet-50
encoder + ReDWeb feature-fusion decoder), NHWC in and out.

A :class:`PLDepthModel` names a model and knows how to build a fresh
``nn.Module`` for it (``make()``; ``make(bn_fold=True)`` and
``make(quant="int8" | "calib")`` build its serving graphs, models/bn_fold.py
and models/quantize.py); ``init_module`` initialises one from a
``torch.Generator`` on a device. The weights live in the module, which the
trainer's state holds. :func:`partition_params` labels parameters for the
BN-only-trainable encoder.

``remat`` recomputes the encoder in the backward pass
(``torch.utils.checkpoint``, :func:`remat_encoder`); ``qres`` trains the
EfficientNet encoder with compressed BN residuals (ops/qres.py). A train
forward given ``pixels`` returns the depths at those pixels only
(ops/sparse_tail.py); the ff_effnet forward given ``encoder`` runs that
serving graph of the encoder without gradient in its place (``qenc``,
train/trainer.py). A forward of either family given ``rows`` (an
ops/halo.py ``RowShard``, train and eval forwards alike) is spatially
sharded: the input and the returned map are this rank's image rows (with
``pixels``, every model rank gets the scores of the whole map); ``rows``
composes with each of the options above.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Iterable, Optional, Sequence

import torch
import torch.utils.checkpoint
from torch import nn

from pldepth_torch.core.device import torch_dtype
from pldepth_torch.core.mesh import RowsGenerator
from pldepth_torch.models import resnet
from pldepth_torch.models.decoders import ReDWebDecoder, SkipConcatDecoder
from pldepth_torch.models.efficientnet import VARIANTS, EfficientNetEncoder
from pldepth_torch.models.layers import TrainPass, reset_parameters
from pldepth_torch.ops.halo import RowShard


def remat_encoder(encoder: nn.Module, x: torch.Tensor, train: TrainPass,
                  rows: Optional[RowShard] = None):
    """``encoder(x, train, rows)`` under ``torch.utils.checkpoint``: its
    activations are recomputed in the backward pass instead of kept.

    The recompute must draw the same drop-path masks: they come from the
    pass's own generator, which ``preserve_rng_state`` does not restore, so
    each run of the encoder gets a generator set to the state the first
    run started from; after the first run the pass's generator is where
    that run left it, as without remat. Only the first run's new BN
    statistics go into the pass (the recompute's are the same values and
    are dropped). Under a process group the recompute issues its BN
    all-reduces again, in module order on every rank; under spatial
    sharding its halo exchanges and squeeze-excite sums too, in the same
    order on every rank, a rank with no rows included (every rank's graph
    holds the same ops, so autograd reaches the recompute at the same
    point on each)."""
    gen = train.gen
    start = gen.get_state() if gen is not None else None
    first = True

    def run(x):
        nonlocal first
        g = None
        if isinstance(gen, RowsGenerator):
            g = gen.with_state(start)
        elif gen is not None:
            g = torch.Generator(device=gen.device)
            g.set_state(start)
        inner = TrainPass(gen=g, mesh=train.mesh)
        out = encoder(x, inner, rows)
        if first:
            first = False
            train.new_stats.update(inner.new_stats)
            if gen is not None:
                gen.set_state(g.get_state())
        return out

    return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False,
                                             preserve_rng_state=False)


def _encode(own: nn.Module, remat: bool, x: torch.Tensor, train: Optional[TrainPass],
            encoder: Optional[nn.Module], rows: Optional[RowShard]):
    """(top, taps) of the model's encoder ``own`` (under ``remat_encoder``
    when ``remat`` in train mode) or of ``encoder``, a frozen serving graph
    run without gradient (qenc); ``rows``: the input's rows (level 0)."""
    rows = None if rows is None else rows.at(0)
    if encoder is not None:
        with torch.no_grad():
            return encoder(x, rows=rows)
    if remat and train is not None:
        return remat_encoder(own, x, train, rows)
    return own(x, train, rows)


def _top_rows(rows: Optional[RowShard]) -> Optional[RowShard]:
    """The rows at the encoder's top, the decoder's input level."""
    return None if rows is None else rows.at(len(rows.heights) - 1)


class EffNetFullyFledged(nn.Module):
    """EfficientNet encoder + skip-concat decoder -> (B, H, W, 1) f32 depth
    (descending depth order, as the HR-WSI convention of the reference)."""

    def __init__(self, variant: str = "b0", dtype: torch.dtype = torch.bfloat16,
                 fused_tail: bool = True, head_ch: int = 32,
                 drop_connect_rate: float = 0.2, bn_fold: bool = False, quant=False,
                 remat: bool = False, qres=None):
        super().__init__()
        self.variant, self.dtype = variant, dtype
        self.fused_tail, self.head_ch = fused_tail, head_ch
        self.remat = remat
        self.encoder = EfficientNetEncoder(variant, dtype=dtype,
                                           drop_connect_rate=drop_connect_rate,
                                           bn_fold=bn_fold, quant=quant, qres=qres)
        self.decoder = SkipConcatDecoder(
            self.encoder.top_ch, self.encoder.tap_channels, head_ch=head_ch,
            dtype=dtype, fused_tail=fused_tail, bn_fold=bn_fold, quant=quant,
        )

    def forward(self, x: torch.Tensor, train: Optional[TrainPass] = None,
                pixels: Optional[torch.Tensor] = None,
                encoder: Optional[nn.Module] = None,
                rows: Optional[RowShard] = None) -> torch.Tensor:
        top, taps = _encode(self.encoder, self.remat, x, train, encoder, rows)
        return self.decoder(top, taps, train, pixels, _top_rows(rows))


class ReDWebFullyFledged(nn.Module):
    """ResNet-50 encoder + ReDWeb feature-fusion decoder -> (B, H, W, 1) f32
    depth. ``stage_blocks`` / ``c4_tap_block`` cut the encoder's depth
    (tests); the registry builds the full one."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 stage_blocks: Sequence[int] = (3, 4, 6, 3), c4_tap_block: int = 2,
                 bn_fold: bool = False, quant=False, remat: bool = False):
        super().__init__()
        self.dtype, self.remat = dtype, remat
        self.encoder = resnet.ResNet50Encoder(dtype, stage_blocks, c4_tap_block,
                                              bn_fold=bn_fold, quant=quant)
        self.decoder = ReDWebDecoder(resnet.TOP_CH, resnet.TAP_CHANNELS, dtype=dtype,
                                     bn_fold=bn_fold, quant=quant)

    def forward(self, x: torch.Tensor, train: Optional[TrainPass] = None,
                pixels=None, rows: Optional[RowShard] = None) -> torch.Tensor:
        c5, taps = _encode(self.encoder, self.remat, x, train, None, rows)
        return self.decoder(c5, taps, train, pixels, _top_rows(rows))


@dataclasses.dataclass(frozen=True)
class PLDepthModel:
    name: str
    make: Callable[..., nn.Module]  # builds the architecture, weights unset
    preprocess: str  # normalization family for data/preprocess.py

    def init_module(self, generator: torch.Generator,
                    device: torch.device | str = "cpu") -> nn.Module:
        """A fresh module, initialised from ``generator`` (on the CPU, so the
        values do not depend on the device), moved to ``device``, eval mode."""
        module = reset_parameters(self.make(), generator)
        return module.to(device).eval()


def _effnet(name: str, variant: str):
    def factory(dtype=torch.bfloat16, fused_tail=True, head_ch=32,
                drop_connect_rate=0.2, remat=False, qres=None) -> PLDepthModel:
        return PLDepthModel(
            name,
            lambda **mode: EffNetFullyFledged(variant, dtype, fused_tail, head_ch,
                                              drop_connect_rate, remat=remat, qres=qres,
                                              **mode),
            "effnet",
        )
    return factory


def _redweb(dtype=torch.bfloat16, fused_tail=True, head_ch=32,
            drop_connect_rate=0.2, remat=False, qres=None) -> PLDepthModel:
    # fused_tail / head_ch / drop_connect_rate are EfficientNet-only;
    # accepted and ignored so the registry's signature stays uniform
    return PLDepthModel("ff_redweb",
                        lambda **mode: ReDWebFullyFledged(dtype, remat=remat, **mode), "caffe")


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
                     fused_tail: bool = True, head_ch: int = 32,
                     drop_connect_rate: float = 0.2, remat: bool = False,
                     qres=None) -> PLDepthModel:
    get_model_type_by_name(model_name)
    if qres and "redweb" in model_name:
        raise ValueError("--qres is implemented for the ff_effnet family")
    return MODEL_REGISTRY[model_name](
        dtype=torch_dtype(compute_dtype), fused_tail=fused_tail, head_ch=head_ch,
        drop_connect_rate=drop_connect_rate, remat=remat, qres=qres,
    )


_BN_NAME = re.compile(r"(^|_)bn\d*$|_bn(_|\d|$)")


def partition_params(names: Iterable[str], freeze_encoder: bool = True) -> Dict[str, str]:
    """Label each flax parameter path (``params/encoder/stem_conv/kernel``,
    the weight bridge's names) "trainable" or "frozen".

    Frozen = encoder params that are not batch-norm affine, the reference's
    BN-only-trainable encoders (pl_hourglass.py:53-57, redweb.py:412-416;
    BN names "...bn", "..._bn..." or ResNet's "bn1"/"bn2"/"bn3"); the rule of
    ``pldepth_tpu/models/pldepth_net.py:partition_params`` on the same
    path components. BN running statistics always update."""

    def label(path: str) -> str:
        keys = path.split("/")
        keys = keys[1:] if keys[0] == "params" else keys
        in_encoder = "encoder" in keys
        is_bn = any(k == "bn" or _BN_NAME.search(k) for k in keys)
        return "frozen" if freeze_encoder and in_encoder and not is_bn else "trainable"

    return {n: label(n) for n in names}


def freeze_params(module: nn.Module, freeze_encoder: bool = True) -> Dict[str, str]:
    """Set ``requires_grad`` of each parameter of ``module`` from
    :func:`partition_params` (frozen leaves get no gradient and no update:
    the JAX package's stop_gradient plus ``set_to_zero``). Returns the
    labels by state_dict name."""
    from pldepth_torch.models.pretrained import flax_key

    labels = {}
    for name, p in module.named_parameters():
        key = flax_key(name, p.dim())
        labels[name] = partition_params([key], freeze_encoder)[key]
        p.requires_grad_(labels[name] == "trainable")
    return labels

"""The Trainer's serving subset (``pldepth_tpu/train/trainer.py``):
state init, ``predict``, ``predict_fused``, the serving-mode policy and
``jit_predict``.

The JAX state is an immutable pytree of params and batch stats; here the
weights live in an ``nn.Module`` that the state holds, and functions that
change weights return a new state (train/checkpoint.py). One device only.
The train step, ``fit`` and multi-device serving come with later slices
(ROADMAP.md queue 1).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from pldepth_torch.core.config import ExperimentConfig
from pldepth_torch.core.device import DeviceLike, resolve_device
from pldepth_torch.core.rng import generator
from pldepth_torch.data.preprocess import normalize_images
from pldepth_torch.models.pldepth_net import EffNetFullyFledged, get_pl_depth_net

log = logging.getLogger(__name__)

_NOT_PORTED_SERVING = (
    "serving mode {!r} is not ported yet: ROADMAP.md queue 1 item 10 "
    "(bn_fold and int8 serving); serve with --fused_encoder true or "
    "--bn_fold false --quantize ''")


@dataclasses.dataclass(frozen=True)
class TrainState:
    step: int
    model: nn.Module

    def replace(self, **kwargs) -> "TrainState":
        return dataclasses.replace(self, **kwargs)


class _HostResult:
    """A prediction on its way to host memory. The copy is queued on the
    stream right behind the forward that made it, so the caller can queue the
    next batch before waiting; ``np.asarray`` waits for this copy only."""

    def __init__(self, pred: torch.Tensor):
        self._host = torch.empty(pred.shape, dtype=pred.dtype, pin_memory=True)
        self._host.copy_(pred, non_blocking=True)
        self._done = torch.cuda.Event()
        self._done.record()

    def __array__(self, dtype=None, copy=None):
        self._done.synchronize()
        arr = self._host.numpy()
        return arr if dtype is None else arr.astype(dtype)


class Trainer:
    def __init__(self, cfg: ExperimentConfig, steps_per_epoch: int = 1,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.steps_per_epoch = max(1, steps_per_epoch)
        self.device = resolve_device(device)
        self.model = get_pl_depth_net(
            cfg.model_name, cfg.compute_dtype, fused_tail=cfg.fused_tail,
            head_ch=cfg.decoder_head_ch,
        )
        self._jit_predict: Dict[object, Callable] = {}
        # (module, input hw) -> encoder plan; the module is kept to check
        # identity, since a plan holds that module's folded weights
        self._plans: Dict[Tuple[int, Tuple[int, int]], Tuple[nn.Module, list]] = {}

    # ------------------------------------------------------------------
    def init_state(self, gen: Optional[torch.Generator] = None) -> TrainState:
        """Seeded random weights (``cfg.seed``), or ``cfg.pretrained_path``
        overlaid on them."""
        gen = gen if gen is not None else generator(self.cfg.seed, "init")
        module = self.model.init_module(gen, self.device)
        if self.cfg.pretrained_path:
            from pldepth_torch.models import pretrained

            pretrained.load_backbone(self.cfg.pretrained_path, module)
        return TrainState(step=0, model=module)

    def _images(self, images) -> torch.Tensor:
        x = torch.as_tensor(images, dtype=torch.float32)
        return normalize_images(x.to(self.device), self.model.preprocess)

    @torch.inference_mode()
    def predict(self, state: TrainState, images) -> torch.Tensor:
        """Batched inference: (B, H, W, 3) images in [0,1] -> (B, H, W) f32."""
        pred = state.model(self._images(images))
        return pred[..., 0] if pred.dim() == 4 else pred

    def _plan(self, module: EffNetFullyFledged, hw: Tuple[int, int]) -> list:
        from pldepth_torch.models.fused_infer import plan_encoder

        key = (id(module), hw)
        hit = self._plans.get(key)
        if hit is None or hit[0] is not module:
            hit = (module, plan_encoder(module.encoder, hw, module.dtype))
            self._plans[key] = hit
        return hit[1]

    @torch.inference_mode()
    def predict_fused(self, state: TrainState, images) -> torch.Tensor:
        """predict() with the encoder on the fused MBConv kernel (every block
        launches K2, ops/fused_mbconv.py). ff_effnet family only; matches
        predict() to compute-dtype rounding. The plan (folded, cast block
        weights) is made once per (model, input size); a state whose weights
        change gets a new model (train/checkpoint.py), hence a new plan."""
        from pldepth_torch.models.fused_infer import encoder_infer

        module = state.model
        if not isinstance(module, EffNetFullyFledged):
            raise NotImplementedError(
                f"predict_fused serves the ff_effnet family, not {type(module).__name__}")
        x = self._images(images)
        plans = self._plan(module, tuple(x.shape[1:3]))
        top, taps = encoder_infer(module.encoder, x, plans, dtype=module.dtype)
        pred = module.decoder(top, taps)
        return pred[..., 0] if pred.dim() == 4 else pred

    @staticmethod
    def serving_mode(fused_encoder: bool, bn_fold: bool, quantize: str = "auto",
                     model_name: str = "ff_effnet"):
        """The one precedence policy for the serving CLI flags (verbatim from
        the JAX package). Returns the value ``jit_predict(fused=...)`` takes."""
        if quantize == "int8":
            if fused_encoder:
                log.warning(
                    "--quantize int8 supersedes --fused_encoder: the int8 "
                    "graph quantizes the XLA BN-folded convs; the fused "
                    "Pallas encoder flag is ignored"
                )
            return "quant"
        if (
            quantize == "auto" and not fused_encoder and bn_fold
            and "redweb" not in model_name
        ):
            return "quant"
        return True if fused_encoder else ("bn_fold" if bn_fold else False)

    def jit_predict(self, fused=False) -> Callable:
        """The serving callable ``(state, images) -> predictions`` for a
        serving mode, memoised per mode. There is no jit: PyTorch runs
        eagerly. On the card the result is handed back as it is copied to
        host memory, so ``np.asarray`` on it waits for that batch only
        (serve/pipeline.py keeps the next batch queued meanwhile).
        ``"bn_fold"`` and ``"quant"`` raise NotImplementedError."""
        if fused in self._jit_predict:
            return self._jit_predict[fused]
        if fused in ("bn_fold", "quant"):
            raise NotImplementedError(_NOT_PORTED_SERVING.format(fused))
        fn = self.predict_fused if fused else self.predict

        def serve(state: TrainState, images):
            pred = fn(state, images)
            return _HostResult(pred) if pred.is_cuda else pred.numpy()

        self._jit_predict[fused] = serve
        return serve


def pad_to_batch(a: np.ndarray, batch_size: int, fill: float = 0.0) -> np.ndarray:
    """Pad the leading axis up to ``batch_size`` with ``fill``
    (``pldepth_tpu/core/mesh.py:pad_to_batch``)."""
    pad = batch_size - a.shape[0]
    if pad <= 0:
        return a
    return np.concatenate([a, np.full((pad, *a.shape[1:]), fill, a.dtype)])

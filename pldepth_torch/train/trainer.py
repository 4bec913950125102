"""The Trainer (``pldepth_tpu/train/trainer.py``): state init, the train
step, ``fit``, the eval step, and serving (``predict``, ``predict_fused``,
``predict_bnfold``, ``prepare_quant`` / ``predict_quant``, the serving-mode
policy, ``jit_predict``).

One train step does, in order, what the JAX step does: images to f32, the
step's generators keyed by (seed, step), the flip augmentation, on-device
ranking sampling, normalisation, the train-mode forward (batch-statistics
BN, drop-path), the ListMLE loss through K1 (forward and backward kernels
on the card), backward, the AMSGrad update (train/optim.py) and the finite
guard: if the loss or any gradient is not finite, params, BN running
statistics and optimizer state keep their values, and ``step`` still
advances. The guard's flag stays on the device: every commit is a
``torch.where`` on it, so a step needs no host sync. ``resident_step``
runs the same step on a batch drawn and decoded on the device from a
resident store (data/resident.py): no batch data crosses the host link.

The JAX state is an immutable pytree; here the weights live in an
``nn.Module`` that the state holds, and the train step updates that module
and its optimizer state in place (no copy of the weights per step) and
returns a state whose ``step`` has advanced. One device only; multi-GPU
data parallelism is ROADMAP.md queue 1 item 11.

The single-device training options of the JAX package: ``grad_accum``
(train/optim.py, optax ``MultiSteps``), ``remat_encoder``
(models/pldepth_net.py ``remat_encoder``), ``sparse_tail`` (the head at
the ranked pixels only, ops/sparse_tail.py, and the loss from those scores
through the sorted K1), ``qres`` (ops/qres.py) and ``qenc``: the frozen
encoder runs a serving graph without gradient inside the step, the
BN-folded one ("bf16") or the int8 one of ``prepare_qenc`` ("int8", its
dense convs on K4 on the card), built once and kept apart from the serving
caches, which every step clears.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import signal
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from pldepth_torch.core.config import ExperimentConfig, sampler_name_for_type
from pldepth_torch.core.device import DeviceLike, resolve_device
from pldepth_torch.core.rng import generator
from pldepth_torch.data.preprocess import normalize_images, random_flip_batch
from pldepth_torch.data.resident import decode_gt
from pldepth_torch.models.layers import TrainPass
from pldepth_torch.models.pldepth_net import (
    EffNetFullyFledged,
    freeze_params,
    get_pl_depth_net,
)
from pldepth_torch.ops.listmle import pl_ranking_loss, pl_ranking_loss_from_scores
from pldepth_torch.ops.sparse_tail import pixels_of
from pldepth_torch.sampling import sample_rankings_batch
from pldepth_torch.train.optim import AmsGrad, AmsGradState
from pldepth_torch.train.schedules import build_schedule

log = logging.getLogger(__name__)

# training options of the JAX package that later slices port
_NOT_PORTED_OPTIONS = (("spatial_sharding", "item 11"),)


def check_ported_options(cfg: ExperimentConfig) -> None:
    """Raise NotImplementedError naming the ROADMAP item of any training
    option the port does not run yet."""
    for name, item in _NOT_PORTED_OPTIONS:
        if getattr(cfg, name):
            raise NotImplementedError(
                f"{name}={getattr(cfg, name)!r} is not ported yet: ROADMAP.md queue 1 {item}")
    if cfg.mesh.model != 1:
        raise NotImplementedError(
            "a mesh model axis (spatial sharding) is not ported yet: ROADMAP.md queue 1 item 11")


@dataclasses.dataclass(frozen=True)
class TrainState:
    """``step`` counts train steps, accepted or not; ``opt`` is the
    optimizer state of the model's trainable parameters (in module order);
    ``seed`` keys the per-step generators."""

    step: int
    model: nn.Module
    opt: Optional[AmsGradState] = None
    seed: int = 0

    def replace(self, **kwargs) -> "TrainState":
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass
class StepMetrics:
    loss: torch.Tensor  # () f32
    lr: torch.Tensor  # () f32, schedule(step)
    finite: torch.Tensor  # () bool: loss and grads all finite
    done: Optional[torch.cuda.Event] = None  # recorded after the step (card only)


def trainable_params(module: nn.Module) -> List[nn.Parameter]:
    return [p for p in module.parameters() if p.requires_grad]


@dataclasses.dataclass(frozen=True)
class QuantState:
    """The int8 serving state ``prepare_quant`` returns and ``predict_quant``
    takes (the JAX package's packed variables): a ``quant="int8"`` model
    with calibrated activation scales."""

    model: nn.Module


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
        check_ported_options(cfg)
        self.model = get_pl_depth_net(
            cfg.model_name, cfg.compute_dtype, fused_tail=cfg.fused_tail,
            head_ch=cfg.decoder_head_ch, remat=cfg.remat_encoder, qres=cfg.qres or None,
        )
        if cfg.qenc:
            if cfg.qenc not in ("bf16", "int8"):
                raise ValueError(f"qenc must be ''|'bf16'|'int8', got {cfg.qenc!r}")
            if not cfg.freeze_encoder:
                raise ValueError("qenc requires freeze_encoder (the probe "
                                 "serves a FROZEN encoder in the train step)")
            if cfg.qres:
                raise ValueError("qenc and qres are mutually exclusive")
            if "redweb" in cfg.model_name:
                raise ValueError("qenc is implemented for the ff_effnet family")
        elif (cfg.pretrained_path and cfg.freeze_encoder
              and "redweb" not in cfg.model_name and not cfg.qres):
            log.info(
                "pretrained frozen encoder detected: --qenc bf16 runs the "
                "encoder serving-style in the train step (+77% measured at "
                "the headline config, quality-gated at this premise — "
                "docs/BENCH.md)")
        # qenc: (the trained module, its encoder's serving graph), and how
        # many times that graph was built
        self._qenc: Optional[Tuple[nn.Module, nn.Module]] = None
        self.qenc_builds = 0
        self.sampler_name = sampler_name_for_type(cfg.sampling_type)
        self.schedule = build_schedule(cfg, self.steps_per_epoch)
        self.optimizer = AmsGrad(self.schedule, cfg.adam_b1, cfg.adam_b2, cfg.adam_eps,
                                 every_k=cfg.grad_accum)
        self._jit_predict: Dict[object, Callable] = {}
        # (module, input hw) -> encoder plan; the module is kept to check
        # identity, since a plan holds that module's folded weights
        self._plans: Dict[Tuple[int, Tuple[int, int]], Tuple[nn.Module, list]] = {}
        # module -> its BN-folded twin, and -> (calib model, packed int8 state_dict)
        self._folded: Dict[int, Tuple[nn.Module, nn.Module]] = {}
        self._packed: Dict[int, Tuple[nn.Module, Tuple[nn.Module, dict]]] = {}
        self._stop_requested = False

    # ------------------------------------------------------------------
    def init_state(self, gen: Optional[torch.Generator] = None) -> TrainState:
        """Seeded random weights (``cfg.seed``), or ``cfg.pretrained_path``
        overlaid on them; frozen leaves (``cfg.freeze_encoder``) get
        ``requires_grad=False``; a fresh optimizer state."""
        gen = gen if gen is not None else generator(self.cfg.seed, "init")
        module = self.model.init_module(gen, self.device)
        if self.cfg.pretrained_path:
            from pldepth_torch.models import pretrained

            pretrained.load_backbone(self.cfg.pretrained_path, module)
        freeze_params(module, self.cfg.freeze_encoder)
        return TrainState(step=0, model=module,
                          opt=self.optimizer.init(trainable_params(module)),
                          seed=self.cfg.seed)

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------
    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        """Host (numpy) or device batch -> f32 tensors on the device; uint8
        images are rescaled to [0, 1]."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v).to(self.device, non_blocking=True)
            if k == "image" and t.dtype == torch.uint8:
                t = t.to(torch.float32) / 255.0
            out[k] = t.to(torch.float32)
        return out

    def _gen(self, state: TrainState, tag: str) -> torch.Generator:
        return generator(state.seed, f"train/{tag}", state.step, self.device)

    @torch.no_grad()
    def _rankings(self, state: TrainState, b: Dict[str, torch.Tensor]):
        """Flip augmentation + on-device ranking sampling of one batch."""
        cfg = self.cfg
        images, gts, masks = b["image"], b["gt"], b["mask"]
        if cfg.augmentation:
            images, gts, masks = random_flip_batch(self._gen(state, "flip"), images, gts, masks)
        rankings = sample_rankings_batch(
            self._gen(state, "sample"), gts, masks,
            sampler_name=self.sampler_name,
            rankings_per_image=cfg.rankings_per_image,
            ranking_size=cfg.ranking_size,
            threshold=cfg.equality_threshold,
            oversample_factor=(float(cfg.oversample_factor)
                               if cfg.oversample_factor is not None else None),
            draw_method=cfg.sampler_draw_method,
        )
        return images, rankings

    def _step(self, state: TrainState, images: torch.Tensor,
              rankings: torch.Tensor) -> Tuple[TrainState, StepMetrics]:
        cfg = self.cfg
        module = state.model
        params = trainable_params(module)
        self._clear_serving_caches()  # the weights change in place
        x = normalize_images(images, self.model.preprocess)
        train = TrainPass(gen=self._gen(state, "droppath"))
        kw = {}
        if cfg.sparse_tail:  # the head at the ranked pixels, scores in rankings order
            kw["pixels"] = pixels_of(rankings, x.shape[2])
        if cfg.qenc:
            kw["encoder"] = self._qenc_encoder(module)
        for p in params:
            p.grad = None
        pred = module(x, train, **kw)
        if cfg.sparse_tail:
            loss = pl_ranking_loss_from_scores(pred, rankings, impl=cfg.listmle_impl)
        else:
            loss = pl_ranking_loss(pred, rankings, impl=cfg.listmle_impl)
        loss.backward()
        loss = loss.detach()
        with torch.no_grad():
            finite = self.optimizer.step(params, state.opt, torch.isfinite(loss))
            for bn, new in train.new_stats.items():
                for buf, v in zip((bn.running_mean, bn.running_var), new):
                    buf.copy_(torch.where(finite, v, buf))
        for p in params:
            p.grad = None
        metrics = StepMetrics(loss=loss, lr=self.schedule(state.step), finite=finite)
        if self.device.type == "cuda":
            metrics.done = torch.cuda.Event()
            metrics.done.record()
        return state.replace(step=state.step + 1), metrics

    def _qenc_encoder(self, module: nn.Module) -> nn.Module:
        """The serving graph of ``module``'s frozen encoder that ``qenc``
        runs: BN-folded ("bf16", folded at the first step and kept while the
        state's module is the same: the encoder gets no gradient, so its
        weights and statistics stay) or int8 (made by ``prepare_qenc`` and
        kept from then on, as the JAX step captures it)."""
        if self._qenc is not None and (self._qenc[0] is module or self.cfg.qenc == "int8"):
            return self._qenc[1]
        if self.cfg.qenc == "int8":
            raise RuntimeError(
                "qenc='int8' needs Trainer.prepare_qenc("
                "state, calib_images) before the first step")
        from pldepth_torch.models.bn_fold import fold_module

        folded = self.model.make(bn_fold=True)
        folded.load_state_dict(fold_module(module), assign=True)
        self._qenc = (module, folded.encoder.eval())
        self.qenc_builds += 1
        return self._qenc[1]

    def prepare_qenc(self, state: TrainState, calib_images) -> None:
        """qenc='int8' setup: calibrate and pack the encoder's int8 serving
        graph (``prepare_quant``; the decoder stays float and trains). Must
        run before the first step."""
        if self.cfg.qenc != "int8":
            raise ValueError("prepare_qenc applies to qenc='int8' only")
        qstate = self.prepare_quant(state, calib_images)
        self._qenc = (state.model, qstate.model.encoder)
        self.qenc_builds += 1

    def train_step(self, state: TrainState, batch) -> Tuple[TrainState, StepMetrics]:
        """One step on an {"image", "gt", "mask"} batch: rankings are
        sampled on the device."""
        images, rankings = self._rankings(state, self._to_device(batch))
        return self._step(state, images, rankings)

    def train_step_fixed(self, state: TrainState, batch) -> Tuple[TrainState, StepMetrics]:
        """One step on an {"image", "rankings"} batch (precomputed
        rankings, the active-learning path)."""
        b = self._to_device(batch)
        return self._step(state, b["image"], b["rankings"])

    @torch.no_grad()
    def resident_batch(self, state: TrainState, arrays: Dict[str, torch.Tensor],
                       idx: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The batch of ``state.step`` from a resident store's ``arrays``
        (data/resident.py): ``batch_size`` rows drawn uniformly with
        replacement by a generator on the store's device keyed by (seed,
        "train/resident", step), gathered, and gt decoded there (``u16 *
        gt_scale``, the scale a device tensor); image and mask stay uint8
        for ``_to_device``. ``idx`` injects the rows."""
        image = arrays["image"]
        if idx is None:
            gen = generator(state.seed, "train/resident", state.step, image.device)
            idx = torch.randint(0, image.shape[0], (self.cfg.batch_size,), generator=gen,
                                device=image.device)
        return {"image": image.index_select(0, idx),
                "gt": decode_gt(arrays["gt"].index_select(0, idx), arrays["gt_scale"]),
                "mask": arrays["mask"].index_select(0, idx)}

    def resident_step(self, state: TrainState, arrays: Dict[str, torch.Tensor],
                      idx: Optional[torch.Tensor] = None) -> Tuple[TrainState, StepMetrics]:
        """One train step on the batch ``resident_batch`` draws: the same
        body as ``train_step``, with no host-to-device batch copy. The draw
        is a pure function of (seed, step), so a resumed run draws what the
        uninterrupted one drew."""
        return self.train_step(state, self.resident_batch(state, arrays, idx))

    def resident_chain(self, n: int) -> Callable:
        """``(state, arrays) -> (state, metrics)`` running ``n`` resident
        steps back to back with no host sync between them; ``loss``, ``lr``
        and ``finite`` each have shape (n,), ``done`` is the last step's.
        The same result as ``n`` calls of ``resident_step`` (the draws are
        keyed by step). ``n <= 1`` gives ``resident_step`` itself. The steps
        are queued one by one from Python; one CUDA graph of the chain (the
        JAX package's single dispatch) is ROADMAP.md queue 1 item 11 / P3."""
        if n <= 1:
            return self.resident_step

        def chain(state: TrainState, arrays) -> Tuple[TrainState, StepMetrics]:
            ms = []
            for _ in range(n):
                state, m = self.resident_step(state, arrays)
                ms.append(m)
            return state, StepMetrics(
                loss=torch.stack([m.loss for m in ms]), lr=torch.stack([m.lr for m in ms]),
                finite=torch.stack([m.finite for m in ms]), done=ms[-1].done)

        return chain

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch) -> torch.Tensor:
        """Loss of the inference forward (running statistics) on an
        {"image", "rankings"} batch: K1 forward only."""
        b = self._to_device(batch)
        pred = state.model(normalize_images(b["image"], self.model.preprocess))
        return pl_ranking_loss(pred, b["rankings"], impl=self.cfg.listmle_impl)

    def _images(self, images) -> torch.Tensor:
        x = torch.as_tensor(images, dtype=torch.float32)
        return normalize_images(x.to(self.device), self.model.preprocess)

    @torch.inference_mode()
    def predict(self, state: TrainState, images) -> torch.Tensor:
        """Batched inference: (B, H, W, 3) images in [0,1] -> (B, H, W) f32."""
        pred = state.model(self._images(images))
        return pred[..., 0] if pred.dim() == 4 else pred

    def _clear_serving_caches(self) -> None:
        for cache in (self._plans, self._folded, self._packed):
            cache.clear()

    @staticmethod
    def _cached(cache: dict, module: nn.Module, make: Callable, key=None):
        """``make()`` once per module (checked by identity: each value holds
        tensors derived from that module's weights)."""
        key = id(module) if key is None else key
        hit = cache.get(key)
        if hit is None or hit[0] is not module:
            hit = (module, make())
            cache[key] = hit
        return hit[1]

    def _plan(self, module: EffNetFullyFledged, hw: Tuple[int, int]) -> list:
        from pldepth_torch.models.fused_infer import plan_encoder

        return self._cached(self._plans, module,
                            lambda: plan_encoder(module.encoder, hw, module.dtype),
                            key=(id(module), hw))

    @torch.inference_mode()
    def predict_fused(self, state: TrainState, images) -> torch.Tensor:
        """predict() with the encoder on the fused MBConv kernel (every block
        launches K2, ops/fused_mbconv.py). ff_effnet family only; matches
        predict() to compute-dtype rounding; another model has no MBConv
        block and is served by predict(), as in the JAX package. The plan
        (folded, cast block weights) is made once per (model, input size); a
        state whose weights change gets a new model (train/checkpoint.py),
        hence a new plan."""
        from pldepth_torch.models.fused_infer import encoder_infer

        module = state.model
        if not isinstance(module, EffNetFullyFledged):
            return self.predict(state, images)
        x = self._images(images)
        plans = self._plan(module, tuple(x.shape[1:3]))
        top, taps = encoder_infer(module.encoder, x, plans, dtype=module.dtype)
        pred = module.decoder(top, taps)
        return pred[..., 0] if pred.dim() == 4 else pred

    def _folded_model(self, module: nn.Module) -> nn.Module:
        from pldepth_torch.models.bn_fold import fold_module

        def make():
            folded = self.model.make(bn_fold=True)
            folded.load_state_dict(fold_module(module), assign=True)
            return folded.eval()

        return self._cached(self._folded, module, make)

    @torch.inference_mode()
    def predict_bnfold(self, state: TrainState, images) -> torch.Tensor:
        """predict() with every batch-norm folded into its conv
        (models/bn_fold.py): the same values to compute-dtype rounding (f32:
        within 2e-5). The folded model is made once per state's model."""
        pred = self._folded_model(state.model)(self._images(images))
        return pred[..., 0] if pred.dim() == 4 else pred

    def prepare_quant(self, state: TrainState, calib_images) -> QuantState:
        """Calibrate and pack the int8 serving state (models/quantize.py).

        ``calib_images`` is one image batch or a list of batches in the
        format ``predict`` takes; activation scales calibrate on them. The
        weights are BN-folded and quantized once per state's model (cached);
        each call returns a new state with its own scales, sharing the
        packed weights."""
        from pldepth_torch.models.quantize import calibrate, pack_module

        module = state.model

        def make():
            calib = self.model.make(quant="calib")
            packed = pack_module(module, calib)
            calib.load_state_dict(packed, assign=True)
            return calib.eval(), packed

        calib, packed = self._cached(self._packed, module, make)
        batches = calib_images if isinstance(calib_images, (list, tuple)) else [calib_images]
        with torch.no_grad():
            qsd = calibrate(calib, packed, (self._images(b) for b in batches))
        qmodel = self.model.make(quant="int8")
        qmodel.load_state_dict(qsd, assign=True)
        return QuantState(model=qmodel.eval())

    @torch.inference_mode()
    def predict_quant(self, qstate: QuantState, images) -> torch.Tensor:
        """predict() on the int8 serving graph: every conv of the model's
        quantization sites runs int8 (ff_effnet: the stem, every MBConv conv,
        depthwise with int8 weights and float activations, the top conv and
        the decoder's 3x3 convs; ff_redweb: every encoder conv and every
        decoder conv but the head's last two), the dense ones on K4;
        squeeze-excite, the heads and every activation stay float.
        ``qstate`` comes from ``prepare_quant``."""
        if not isinstance(qstate, QuantState):
            raise TypeError("predict_quant takes the QuantState of prepare_quant, "
                            f"not {type(qstate).__name__}")
        pred = qstate.model(self._images(images))
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
        ``"quant"`` takes the ``QuantState`` of ``prepare_quant`` in place of
        the TrainState, as in the JAX package."""
        if fused in self._jit_predict:
            return self._jit_predict[fused]
        if fused == "bn_fold":
            fn = self.predict_bnfold
        elif fused == "quant":
            fn = self.predict_quant
        else:
            fn = self.predict_fused if fused else self.predict

        def serve(state: TrainState, images):
            pred = fn(state, images)
            return _HostResult(pred) if pred.is_cuda else pred.numpy()

        self._jit_predict[fused] = serve
        return serve

    def jit_predict_resident(self, local_batch: int) -> Callable:
        """Serving straight from a resident store (data/resident.py):
        ``(state, images_u8, start) -> preds`` forwards rows ``start`` to
        ``start + local_batch`` of the store's (N, H, W, 3) uint8 image
        tensor, sliced and rescaled on its device, so no image crosses the
        host link (the streaming path sends 2.4 MB an image at 448^2 f32).
        One device: the JAX package's per-shard rows are the store's rows
        here. The result is handed back as ``jit_predict``'s is."""
        key = ("resident", local_batch)
        if key in self._jit_predict:
            return self._jit_predict[key]

        def serve(state: TrainState, images_u8: torch.Tensor, start: int):
            rows = images_u8.narrow(0, start, local_batch).to(torch.float32)
            # a division by a tensor: on CUDA a Python divisor becomes a
            # multiply by its reciprocal, one ulp off the u8 / 255 of XLA
            pred = self.predict(state, rows / torch.full_like(rows[:1, :1, :1, :1], 255.0))
            return _HostResult(pred) if pred.is_cuda else pred.numpy()

        self._jit_predict[key] = serve
        return serve

    # ------------------------------------------------------------------
    # loops
    # ------------------------------------------------------------------
    def request_stop(self) -> None:
        """Ask fit() to stop at the next step boundary (checkpoint first if a
        ``ckpt`` manager was given). Called by the SIGTERM handler; safe to
        call from callbacks or other threads."""
        self._stop_requested = True

    @contextlib.contextmanager
    def _preemption_guard(self):
        """Route SIGTERM to request_stop() for the duration of fit()."""
        if threading.current_thread() is not threading.main_thread():
            yield
            return

        def handler(signum, frame):
            log.warning("SIGTERM received -- stopping at next step boundary")
            self.request_stop()

        prev = signal.signal(signal.SIGTERM, handler)
        try:
            yield
        finally:
            signal.signal(signal.SIGTERM, prev)

    def fit(self, state: TrainState, train_iter: Optional[Iterator[Dict[str, np.ndarray]]],
            epochs: Optional[int] = None,
            val_iter_factory: Optional[Callable[[], Iterator[Dict[str, np.ndarray]]]] = None,
            callbacks=(), ckpt=None, resident_store=None) -> Tuple[TrainState, Dict[str, list]]:
        """Run the train loop (``pldepth_tpu`` ``Trainer.fit``).

        ``ckpt``: optional CheckpointManager for full-state saves labelled by
        global step, one per ``checkpoint_every_epochs`` epochs (and after
        the last) plus one on request_stop()/SIGTERM. Resume is driven by
        ``state.step``: the caller builds ``train_iter`` with
        ``start_step=state.step``, so the data stream, the per-step
        generators and the LR schedule line up with the uninterrupted run.
        The next host batch is fetched while the step runs on the card; at
        most two steps (or chains) are in flight (the loop waits for the
        one before after queueing the next).

        ``resident_store``: a data/resident.py ResidentStore; the steps draw
        their batches from it on the device and ``train_iter`` is ignored
        (pass None). ``cfg.resident_chain_steps`` steps run per
        ``resident_chain`` call; ``on_step_end`` still fires every
        ``log_every`` steps, and request_stop() lands between chains. Resume
        stays exact: the draws are a pure function of (seed, step)."""
        epochs = epochs if epochs is not None else self.cfg.epochs
        history: Dict[str, list] = {"loss": [], "val_loss": [], "lr": [], "ips": []}
        start_step = state.step
        start_epoch = start_step // self.steps_per_epoch
        offset = start_step % self.steps_per_epoch
        if start_step:
            log.info("resuming at step %d (epoch %d + %d steps)", start_step, start_epoch, offset)
        resident = resident_store is not None
        chain_n = max(1, self.cfg.resident_chain_steps) if resident else 1
        preempted = False
        for cb in callbacks:
            cb.on_train_begin(self)
        with self._preemption_guard():
            next_batch = None if resident else next(train_iter)
            for epoch in range(start_epoch, epochs):
                t0 = time.time()
                metrics_all: List[StepMetrics] = []
                step_i = offset if epoch == start_epoch else 0
                while step_i < self.steps_per_epoch:
                    if resident:
                        k = min(chain_n, self.steps_per_epoch - step_i)
                        state, metrics = self.resident_chain(k)(state, resident_store.arrays)
                    else:
                        k = 1
                        state, metrics = self.train_step(state, next_batch)
                        # overlap the next host fetch with the step on the card
                        next_batch = next(train_iter)
                    metrics_all.append(metrics)
                    if len(metrics_all) >= 2 and metrics_all[-2].done is not None:
                        metrics_all[-2].done.synchronize()
                    for j in range(k):
                        if self.cfg.log_every and (step_i + j + 1) % self.cfg.log_every == 0:
                            for cb in callbacks:
                                if hasattr(cb, "on_step_end"):
                                    cb.on_step_end(self, epoch * self.steps_per_epoch + step_i + j,
                                                   {"loss": float(metrics.loss.reshape(-1)[j]),
                                                    "lr": float(metrics.lr.reshape(-1)[j])})
                    step_i += k
                    if self._stop_requested:
                        preempted = True
                        break
                losses = ([float(x) for x in torch.cat([m.loss.reshape(-1)
                                                        for m in metrics_all]).cpu()]
                          if metrics_all else [])
                n_steps = len(losses)
                # finite covers grads too: a NaN backward with a finite loss
                # must still stop the run (the guard kept the old params)
                finite = bool(np.all(np.isfinite(losses))) and all(
                    bool(f) for f in torch.cat([m.finite.reshape(-1) for m in metrics_all]).cpu()
                ) if metrics_all else True
                dt = time.time() - t0
                history["loss"].append(float(np.mean(losses)) if losses else float("nan"))
                history["lr"].append(float(metrics_all[-1].lr.reshape(-1)[-1])
                                     if metrics_all else float("nan"))
                history["ips"].append(n_steps * self.cfg.batch_size / dt)

                if preempted:
                    if ckpt is not None:
                        ckpt.save(state.step, state)
                        log.warning("preemption checkpoint saved at step %d", state.step)
                    history["preempted"] = True
                    break

                val_loss = None
                if val_iter_factory is not None:
                    vlosses = [float(self.eval_step(state, vb)) for vb in val_iter_factory()]
                    val_loss = float(np.mean(vlosses)) if vlosses else float("nan")
                    history["val_loss"].append(val_loss)

                log.info("epoch %d loss=%.4f val=%s ips=%.1f lr=%.5f", epoch,
                         history["loss"][-1],
                         f"{val_loss:.4f}" if val_loss is not None else "-",
                         history["ips"][-1], history["lr"][-1])
                if ckpt is not None and (
                        (epoch + 1) % max(1, self.cfg.checkpoint_every_epochs) == 0
                        or epoch == epochs - 1):
                    ckpt.save(state.step, state)
                for cb in callbacks:
                    cb.on_epoch_end(self, state, epoch, history)
                if not finite:
                    log.error("non-finite loss at epoch %d -- terminating (NaN guard)", epoch)
                    break
        self._stop_requested = False
        for cb in callbacks:
            cb.on_train_end(self, state, history)
        return state, history


def pad_to_batch(a: np.ndarray, batch_size: int, fill: float = 0.0) -> np.ndarray:
    """Pad the leading axis up to ``batch_size`` with ``fill``
    (``pldepth_tpu/core/mesh.py:pad_to_batch``)."""
    pad = batch_size - a.shape[0]
    if pad <= 0:
        return a
    return np.concatenate([a, np.full((pad, *a.shape[1:]), fill, a.dtype)])

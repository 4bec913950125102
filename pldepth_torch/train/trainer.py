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

On one card (no process group) the step's device work, from the device
batch to the end of the update, is one CUDA graph, captured once and
replayed at every step (``train_step``): the host then queues a step
with one launch instead of thousands, and the card sets the pace. The
first step for a state and batch shape runs eagerly on a side stream, as
the graph's warm-up, and the graph is captured after it; later steps
copy their batch into the graph's input buffers, re-seed the step's
generators and replay. A replay adds the captured step's launches to the
kernel wrappers' counters (``ranking_loss_fwd.launches``, ...), which
thus count every step's launches, eager or replayed, and not the
capture's, which launches nothing. The graph is kept on the
Trainer across ``fit`` calls and captured again when the module, a
storage of its parameters, buffers or optimizer state, or the batch's
shapes and dtypes change. ``remat_encoder`` stays eager (its recompute
sets generator states on the host), as do the CPU, a process group and
``train_step_fixed``. A replay runs the eager step's kernels on the same
inputs and draws: its loss, finite flag and BN statistics are the eager
step's bit for bit; the backward's atomic adds (the bilinear upsample's,
K1's) sum in an order of their own, as they do between two eager steps.

The JAX state is an immutable pytree; here the weights live in an
``nn.Module`` that the state holds, and the train step updates that module
and its optimizer state in place (no copy of the weights per step) and
returns a state whose ``step`` has advanced.

Data parallelism (core/mesh.py): one process per card, ``self.mesh`` its
place in the group. Each rank steps on its own rows (streaming: the
``cfg.batch_size`` rows its sharded feed gives; resident: ``batch_size //
W`` rows drawn from its shard of the store), and every reduction over the
batch is over the global batch, as under the JAX package's sharded step:
BN statistics (models/layers.py ``batch_moments``), the loss (each rank's
mean NLL scaled by 1/W, so the ranks' sum is the global mean; the reported
loss is the all-reduced global mean), the gradient (one flat all-reduce
before the finite guard, so every rank accepts or refuses the step alike),
the random draws (made at the global batch's shape, each rank keeping its
rows), the eval loss and the int8 calibration maxima. The ranks' states
stay bit-equal; ``replicate`` copies rank 0's state after init and
restore. With no process group every one of these is the single-process
step, unchanged.

The mesh's model axis (``cfg.mesh.model`` = M > 1): world = data x model,
rank r at data index r // M. Without ``spatial_sharding`` the M ranks of a
data index hold the same rows and compute the same step; the loss is
scaled by 1/(D M), the flat gradient and the BN sums run over the world
(every row counted M times, which leaves the mean and the variance as
they are), and the draws, the feed and the store are keyed by the data
index. With ``spatial_sharding`` (``pldepth_tpu`` ``Trainer._spatial_axis``)
each rank holds a range of image rows (ops/halo.py ``RowShard``; a batch
given at full height is cut to the rank's rows on the host before the
upload): the forward exchanges halos, the squeeze-excite means sum over
the model ranks, BN sums over the world, the sampler reads the gt and mask
gathered over the model ranks, and the loss (K1 on the card) reads the
prediction map gathered over them, so every model rank computes the
unsharded loss of its data index; each rank's backward gives its share of
the gradient, and the world's sum of those is the single-process gradient.
Both model families shard (ff_redweb's ResNet has the same five stride-2
levels) and every training option composes with it: ``sparse_tail``'s
ranks each score the ranked pixels they own and sum the scores over the
model ranks (no map is gathered), ``qenc`` runs its frozen serving encoder
on the rank's rows (int8: the halo exchanged as int8, K4 reading the rows
in place), ``qres`` takes its int8 ``amax`` over the world, the remat
recompute reissues the encoder's collectives, and ``grad_accum``
accumulates the all-reduced gradient, so its state stays equal on every
rank.

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
import weakref
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from pldepth_torch.core import mesh as mesh_lib
from pldepth_torch.core.config import ExperimentConfig, sampler_name_for_type
from pldepth_torch.core.device import DeviceLike, resolve_device
from pldepth_torch.core.mesh import Mesh, RowsGenerator, make_mesh
from pldepth_torch.core.mesh import pad_to_batch  # noqa: F401  (importable here, as before)
from pldepth_torch.core.rng import derive_seed, generator
from pldepth_torch.data.preprocess import normalize_images, random_flip_batch
from pldepth_torch.data.resident import decode_gt
from pldepth_torch.models.efficientnet import SPATIAL_LEVELS
from pldepth_torch.models.layers import TrainPass
from pldepth_torch.models.pldepth_net import (
    EffNetFullyFledged,
    freeze_params,
    get_pl_depth_net,
)
from pldepth_torch.obs.spans import span
from pldepth_torch.ops.halo import RowShard
from pldepth_torch.ops.listmle import pl_ranking_loss, pl_ranking_loss_from_scores
from pldepth_torch.ops.sparse_tail import pixels_of
from pldepth_torch.sampling import sample_rankings_batch
from pldepth_torch.train.optim import AmsGrad, AmsGradState, flat_grad
from pldepth_torch.train.schedules import build_schedule

log = logging.getLogger(__name__)

# the train step's random draws, one generator each, keyed by (seed, step)
STEP_DRAWS = ("flip", "sample", "droppath")


def _launch_counters() -> Tuple[Tuple[object, str], ...]:
    """The kernel wrappers' counters (``<wrapper>.<name>``) that a train
    step can move."""
    from pldepth_torch.ops import (banded_mbconv, fused_mbconv, listmle_kernel, quant_conv,
                                   quant_matmul)

    return ((listmle_kernel.listmle_fwd, "launches"), (listmle_kernel.listmle_bwd, "launches"),
            (listmle_kernel.ranking_loss_fwd, "launches"),
            (listmle_kernel.ranking_loss_bwd, "launches"),
            (quant_matmul.quant_matmul, "launches"),
            (quant_conv.quant_conv2d, "window_launches"), (quant_conv.im2col_same, "calls"),
            (fused_mbconv.fused_mbconv_infer, "launches"),
            (banded_mbconv.banded_mbconv_infer, "launches"))


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


@dataclasses.dataclass
class _StepGraph:
    """One captured train step: the graph, what it was captured for (the
    module by weak reference, and ``Trainer._graph_key``), its input
    buffers, its outputs (the loss and the finite flag) and the launches
    it counted on each wrapper's counter."""

    graph: "torch.cuda.CUDAGraph"
    module: "weakref.ref"
    key: tuple
    inputs: Dict[str, torch.Tensor]
    loss: torch.Tensor
    finite: torch.Tensor
    launches: Tuple[Tuple[Tuple[object, str], int], ...]


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
                 device: DeviceLike = None, mesh: Optional[Mesh] = None):
        """``mesh``: the process's place in the group's (data, model) layout
        (default: core/mesh.py ``make_mesh(cfg.mesh)`` of the process's
        group, a world of one without a group); ``device`` defaults to the
        mesh's card."""
        self.cfg = cfg
        self.steps_per_epoch = max(1, steps_per_epoch)
        self.mesh = mesh if mesh is not None else make_mesh(cfg.mesh)
        self._rows: Optional[RowShard] = None
        self.device = resolve_device(
            self.mesh.device if device is None and self.mesh.active else device)
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
        # the one-card step graph (train_step) and one generator a draw
        # (re-seeded every replay)
        self._graph: Optional[_StepGraph] = None
        self._draws: Dict[str, torch.Generator] = {}
        self._capturing = False
        self.graph_captures = 0
        self.graph_replays = 0

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
        return self.replicate(TrainState(step=0, model=module,
                                         opt=self.optimizer.init(trainable_params(module)),
                                         seed=self.cfg.seed))

    def replicate(self, state: TrainState) -> TrainState:
        """Rank 0's weights, BN statistics and optimizer state on every rank
        (``pldepth_tpu`` ``Trainer.replicate``): after init, a restore or a
        weights load. Seeded init already agrees; this is the guard. The
        identity with no process group."""
        if self.mesh.active:
            tensors = list(state.model.state_dict().values())
            if state.opt is not None:
                tensors += list(state.opt.state_dict().values())
            self.mesh.broadcast_(tensors)
        return state

    # ------------------------------------------------------------------
    # spatial sharding
    # ------------------------------------------------------------------
    def _spatial(self) -> Optional[RowShard]:
        """This rank's rows under spatial sharding (``pldepth_tpu``
        ``Trainer._spatial_axis``): None without the flag or with a model
        axis of 1; ValueError where ``input_size`` does not split over the
        model axis, as in the JAX package."""
        if not self.cfg.spatial_sharding or self.mesh.model <= 1:
            return None
        m = self.mesh.model
        if self.cfg.input_size % m:
            raise ValueError(f"input_size {self.cfg.input_size} not divisible by the "
                             f"spatial (model) axis of size {m}")
        if self._rows is None:
            self._rows = RowShard.for_mesh(self.mesh, self.cfg.input_size, SPATIAL_LEVELS)
        return self._rows

    def _step_rows(self) -> Optional[RowShard]:
        """:meth:`_spatial` for a step, which exchanges rows: it needs the
        model group of a process group."""
        rows = self._spatial()
        if rows is not None and not self.mesh.model_active:
            raise RuntimeError("a spatially sharded step needs the model group of a process "
                               "group (core/mesh.py init_distributed, then make_mesh)")
        return rows

    def input_rows(self) -> Optional[Tuple[int, int]]:
        """This rank's image rows ``(start, end)`` under spatial sharding
        (the resident store's slice), else None."""
        rows = self._spatial()
        return None if rows is None else rows.span

    def shard_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """This rank's part of a global host batch (``pldepth_tpu``
        ``Trainer.shard_batch``): its data index's block of rows and, under
        spatial sharding, its image rows of "image", "gt" and "mask"."""
        return mesh_lib.shard_batch(self.mesh, batch, self.input_rows())

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------
    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        """Host (numpy) or device batch -> f32 tensors on the device; uint8
        images are rescaled to [0, 1]. Under spatial sharding an "image",
        "gt" or "mask" given at the image's full height is cut to this
        rank's rows first (on the host for a host batch)."""
        rows = self._spatial()
        out = {}
        for k, v in batch.items():
            if rows is not None and k in ("image", "gt", "mask") and v.shape[1] == rows.height:
                v = v[:, rows.span[0]:rows.span[1]]
            out[k] = torch.as_tensor(v).to(self.device, non_blocking=True)
        return self._as_f32(out)

    @staticmethod
    def _as_f32(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A device batch as f32, a uint8 image rescaled to [0, 1]."""
        out = {}
        for k, t in batch.items():
            if k == "image" and t.dtype == torch.uint8:
                t = t.to(torch.float32) / 255.0
            out[k] = t.to(torch.float32)
        return out

    def _gen(self, state: TrainState, tag: str) -> RowsGenerator:
        """The step's generator of ``tag``; its batch draws are made at the
        global batch's shape and this rank keeps the rows of its data
        index. While the step graph is captured: the graph's generator of
        ``tag``, which every replay re-seeds to the step's key."""
        gen = (self._draws[tag] if self._capturing else
               generator(state.seed, f"train/{tag}", state.step, self.device))
        return RowsGenerator(gen, self.mesh.data_index, self.mesh.data)

    def _reseed(self, state: TrainState) -> None:
        """Set each draw's generator to ``generator(seed, "train/<tag>",
        step)``: the seed, at offset 0."""
        for tag, gen in self._draws.items():
            gen.manual_seed(derive_seed(state.seed, f"train/{tag}", state.step))

    @torch.no_grad()
    def _rankings(self, state: TrainState, b: Dict[str, torch.Tensor]):
        """Flip augmentation + on-device ranking sampling of one batch. The
        flip is horizontal, so a rank flips its own rows; under spatial
        sharding the sampler reads the whole gt and mask, gathered over the
        model ranks."""
        cfg = self.cfg
        images, gts, masks = b["image"], b["gt"], b["mask"]
        if cfg.augmentation:
            images, gts, masks = random_flip_batch(self._gen(state, "flip"), images, gts, masks)
        rows = self._step_rows()
        if rows is not None:
            gts, masks = rows.gather(gts), rows.gather(masks)
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
        self._clear_serving_caches()  # the weights change in place
        return self._finish(state, *self._update(state, images, rankings))

    def _finish(self, state: TrainState, loss: torch.Tensor,
                finite: torch.Tensor) -> Tuple[TrainState, StepMetrics]:
        metrics = StepMetrics(loss=loss, lr=self.schedule(state.step), finite=finite)
        if self.device.type == "cuda" and not self._capturing:
            metrics.done = torch.cuda.Event()
            metrics.done.record()
        return state.replace(step=state.step + 1), metrics

    def _update(self, state: TrainState, images: torch.Tensor,
                rankings: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward, loss, backward and the guarded update of one step, in
        place on the state's module and optimizer state: (loss, finite),
        on the device."""
        cfg = self.cfg
        module = state.model
        params = trainable_params(module)
        for p in params:
            p.grad = None
        with span("step.forward"):
            x = normalize_images(images, self.model.preprocess)
            train = TrainPass(gen=self._gen(state, "droppath"), mesh=self.mesh)
            kw = {}
            if cfg.sparse_tail:  # the head at the ranked pixels, scores in rankings order
                kw["pixels"] = pixels_of(rankings, x.shape[2])
            if cfg.qenc:
                kw["encoder"] = self._qenc_encoder(module)
            rows = self._step_rows()
            if rows is not None:
                kw["rows"] = rows
            pred = module(x, train, **kw)
            if rows is not None and not cfg.sparse_tail:
                pred = rows.gather(pred)  # the whole map of the data index on each model rank
            if cfg.sparse_tail:
                loss = pl_ranking_loss_from_scores(pred, rankings, impl=cfg.listmle_impl)
            else:
                loss = pl_ranking_loss(pred, rankings, impl=cfg.listmle_impl)
        mesh = self.mesh
        with span("step.backward"):
            # each rank's share of the global mean (K1 means over its data
            # index's lists, which the model ranks of that index all compute)
            (loss * (1.0 / mesh.world) if mesh.active else loss).backward()
        loss = loss.detach()
        with span("step.update"), torch.no_grad():
            grad = flat_grad(params)
            if mesh.active:
                mesh.reduce_(grad)
                loss = mesh.reduce_(loss.clone()) / mesh.world
            finite = self.optimizer.step(params, state.opt, torch.isfinite(loss), grad=grad)
            for bn, new in train.new_stats.items():
                for buf, v in zip((bn.running_mean, bn.running_var), new):
                    buf.copy_(torch.where(finite, v, buf))
        for p in params:
            p.grad = None
        return loss, finite

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
        run before the first step. Under spatial sharding every rank
        calibrates unsharded on the whole ``calib_images`` it is given, so
        the ranks hold the same scales (those of one process on the same
        images)."""
        if self.cfg.qenc != "int8":
            raise ValueError("prepare_qenc applies to qenc='int8' only")
        qstate = self.prepare_quant(state, calib_images)
        self._qenc = (state.model, qstate.model.encoder)
        self.qenc_builds += 1

    def train_step(self, state: TrainState, batch) -> Tuple[TrainState, StepMetrics]:
        """One step on an {"image", "gt", "mask"} batch: rankings are
        sampled on the device. On one card a replay of the step graph
        (module docstring), else eager."""
        with span("step", state.step):
            if self._graphed():
                return self._graphed_step(state, batch)
            return self._eager_step(state, batch)

    def _eager_step(self, state: TrainState, batch) -> Tuple[TrainState, StepMetrics]:
        with span("step.upload"):
            b = self._to_device(batch)
        with span("step.sample"):
            images, rankings = self._rankings(state, b)
        del b  # the uploaded gt and mask are not kept through the step
        return self._step(state, images, rankings)

    # ------------------------------------------------------------------
    # the step graph
    # ------------------------------------------------------------------
    def _graphed(self) -> bool:
        """Whether ``train_step`` runs the step graph: on a card with no
        process group (NCCL and the gloo-staged collectives stay eager),
        and not under ``remat_encoder``, whose recompute reads and sets its
        generator's state on the host."""
        return (self.device.type == "cuda" and not self.mesh.active
                and not self.cfg.remat_encoder)

    def _graph_key(self, state: TrainState, batch: Dict[str, torch.Tensor]) -> tuple:
        """What a step graph is captured for: the module, the storages of
        its parameters (and which of them train), buffers and optimizer
        state, the int8 encoder ``prepare_qenc`` made (the bf16 one is the
        module's own, made at its first step), and the batch's names,
        shapes and dtypes. Steps that update the state in place keep it."""
        module = state.model
        # the fields themselves (state_dict() would copy them)
        opt = [t for t in vars(state.opt).values() if t is not None] if state.opt else []
        int8 = self.cfg.qenc == "int8" and self._qenc is not None
        return (id(module),
                tuple((p.data_ptr(), p.requires_grad) for p in module.parameters()),
                tuple(t.data_ptr() for t in (*module.buffers(), *opt)),
                id(self._qenc[1]) if int8 else None,
                tuple((k, tuple(t.shape), t.dtype) for k, t in batch.items()))

    def _graphed_step(self, state: TrainState, batch) -> Tuple[TrainState, StepMetrics]:
        src = {k: torch.as_tensor(v) for k, v in batch.items()}
        g = self._graph
        if g is not None and g.module() is state.model and g.key == self._graph_key(state, src):
            self._clear_serving_caches()  # the weights change in place
            with span("step.upload"):
                for k, t in src.items():
                    g.inputs[k].copy_(t, non_blocking=True)
            with span("step.replay"):
                self._reseed(state)
                g.graph.replay()
            for (fn, name), n in g.launches:
                setattr(fn, name, getattr(fn, name) + n)
            self.graph_replays += 1
            return self._finish(state, g.loss.clone(), g.finite.clone())
        # a new state or batch shape: this step runs eagerly on a side
        # stream, as the graph's warm-up, then the graph is captured
        self._graph = None  # its memory goes before another capture
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self._eager_step(state, batch)
        main.wait_stream(side)
        self._graph = self._capture(state, src)
        return out

    def _capture(self, state: TrainState, src: Dict[str, torch.Tensor]) -> _StepGraph:
        """Capture the step's device work on ``state`` (nothing runs): the
        batch from input buffers shaped as ``src``, the flip and the
        sampler, and ``_step``: the forward, K1, the backward and the
        guarded update. The key is taken after the warm-up, which makes
        what a first step makes (the ``qenc`` bf16 encoder, K1's
        workspace). The wrappers' counters are set back: the capture
        launched nothing."""
        key = self._graph_key(state, src)
        inputs = {k: torch.empty(t.shape, dtype=t.dtype, device=self.device)
                  for k, t in src.items()}
        for tag in STEP_DRAWS:
            if tag not in self._draws:
                self._draws[tag] = torch.Generator(device=self.device)
        graph = torch.cuda.CUDAGraph()
        for gen in self._draws.values():
            graph.register_generator_state(gen)
        before = [(c, getattr(*c)) for c in _launch_counters()]
        self._capturing = True
        try:
            with torch.cuda.graph(graph):
                with span("step.sample"):
                    images, rankings = self._rankings(state, self._as_f32(inputs))
                _, metrics = self._step(state, images, rankings)
        finally:
            self._capturing = False
            launches = tuple((c, getattr(*c) - n) for c, n in before if getattr(*c) != n)
            for (fn, name), n in before:
                setattr(fn, name, n)
        self.graph_captures += 1
        return _StepGraph(graph, weakref.ref(state.model), key, inputs, metrics.loss,
                          metrics.finite, launches)

    def train_step_fixed(self, state: TrainState, batch) -> Tuple[TrainState, StepMetrics]:
        """One step on an {"image", "rankings"} batch (precomputed
        rankings, the active-learning path)."""
        with span("step", state.step):
            with span("step.upload"):
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
        for ``_to_device``. ``idx`` injects the rows. Under a process group
        ``batch_size`` is the global batch: each rank draws ``batch_size //
        D`` rows from its data index's shard, data index d > 0 folded into
        the key (the JAX draw's ``fold_in(key, axis_index(data))``), so the
        model ranks of one data index draw the same samples (under spatial
        sharding each holds its rows of them)."""
        image = arrays["image"]
        with span("step.draw", state.step):
            if idx is None:
                data, index = self.mesh.data, self.mesh.data_index
                if self.cfg.batch_size % data:
                    raise ValueError(
                        f"batch_size {self.cfg.batch_size} not divisible by data axis {data}")
                tag = "train/resident" + (f"/{index}" if index else "")
                gen = generator(state.seed, tag, state.step, image.device)
                idx = torch.randint(0, image.shape[0], (self.cfg.batch_size // data,),
                                    generator=gen, device=image.device)
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
        are queued one by one from Python, each a replay of the step graph
        on one card; one CUDA graph of the whole chain (the JAX package's
        single dispatch) is a speed property, ROADMAP.md P3."""
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
        {"image", "rankings"} batch: K1 forward only. Under a process group
        each rank passes its rows and gets the global mean; under spatial
        sharding the forward is sharded and the loss reads the gathered
        map."""
        rows = self._step_rows()
        b = self._to_device(batch)
        x = normalize_images(b["image"], self.model.preprocess)
        pred = state.model(x) if rows is None else rows.gather(state.model(x, rows=rows))
        loss = pl_ranking_loss(pred, b["rankings"], impl=self.cfg.listmle_impl)
        if self.mesh.active:
            loss = self.mesh.reduce_(loss.clone()) / self.mesh.world
        return loss

    def _images(self, images) -> torch.Tensor:
        # every predict's upload; a served chunk's lies under serve.infer
        with span("upload"):
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
        packed weights. Under a process group each rank calibrates on its
        own batches and the maxima are the ranks' largest."""
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
            # under a process group every rank packs the same scales: the
            # calibration maxima are all-reduced over the ranks' batches
            qsd = calibrate(calib, packed, (self._images(b) for b in batches),
                            amax_reduce=self.mesh.max if self.mesh.active else None)
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
        eagerly. Under a process group each rank serves the images it is
        given, whole (data-parallel, replicated over a model axis, as the
        JAX package serves). On the card the result is handed back as it is copied to
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
            callbacks=(), ckpt=None, resident_store=None,
            profile_dir: Optional[str] = None) -> Tuple[TrainState, Dict[str, list]]:
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
        stays exact: the draws are a pure function of (seed, step).

        Under a process group every rank runs ``fit`` on its own feed: the
        losses, the finite flags and the validation loss are the global
        ones, so every rank makes the same NaN and epoch decisions; a stop
        asked on any rank (SIGTERM, ``request_stop``) stops every rank at
        the same step; ``ckpt`` writes on rank 0 only (train/checkpoint.py)
        and ``ips`` counts the global batch.

        ``profile_dir``: trace the loop from the end of its first step (or
        chain) until three more steps have run, with obs/profiling.py's
        ``profile_trace`` into ``profile_dir``: the steps' ops and kernels
        under the program's spans (the step's phases, ``fit.feed``,
        ``fit.wait``, ``mesh.stop``, ``fit.epoch`` where an epoch ends
        inside)."""
        epochs = epochs if epochs is not None else self.cfg.epochs
        history: Dict[str, list] = {"loss": [], "val_loss": [], "lr": [], "ips": []}
        start_step = state.step
        start_epoch = start_step // self.steps_per_epoch
        offset = start_step % self.steps_per_epoch
        if start_step:
            log.info("resuming at step %d (epoch %d + %d steps)", start_step, start_epoch, offset)
        resident = resident_store is not None
        chain_n = max(1, self.cfg.resident_chain_steps) if resident else 1
        # the global batch: resident batch_size is global, a streaming feed
        # gives batch_size rows to each rank
        rows_per_step = self.cfg.batch_size * (1 if resident else self.mesh.data)
        preempted = False
        for cb in callbacks:
            cb.on_train_begin(self)
        n_run, traced_from = 0, None  # steps run in this call; the profiled window's start
        with self._preemption_guard(), contextlib.ExitStack() as window:
            if not resident:
                with span("fit.feed", state.step):
                    next_batch = next(train_iter)
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
                        with span("fit.feed", state.step):
                            next_batch = next(train_iter)
                    metrics_all.append(metrics)
                    if len(metrics_all) >= 2 and metrics_all[-2].done is not None:
                        # the last step of the chain before the one just queued
                        with span("fit.wait", state.step - k - 1):
                            metrics_all[-2].done.synchronize()
                    for j in range(k):
                        if self.cfg.log_every and (step_i + j + 1) % self.cfg.log_every == 0:
                            for cb in callbacks:
                                if hasattr(cb, "on_step_end"):
                                    cb.on_step_end(self, epoch * self.steps_per_epoch + step_i + j,
                                                   {"loss": float(metrics.loss.reshape(-1)[j]),
                                                    "lr": float(metrics.lr.reshape(-1)[j])})
                    step_i += k
                    # the ranks agree: a stop asked on any rank stops all
                    # of them at this step (a host all-reduce, no card sync)
                    if self.mesh.any(self._stop_requested):
                        preempted = True
                        break
                    n_run += k
                    if profile_dir and traced_from is None:  # first-use costs stay outside
                        from pldepth_torch.obs.profiling import profile_trace

                        traced_from = n_run
                        window.enter_context(profile_trace(profile_dir))
                    elif profile_dir and n_run - traced_from >= 3:
                        window.close()
                        profile_dir = None
                with span("fit.epoch", state.step):
                    losses = ([float(x) for x in torch.cat([m.loss.reshape(-1)
                                                            for m in metrics_all]).cpu()]
                              if metrics_all else [])
                    # finite covers grads too: a NaN backward with a finite
                    # loss must still stop the run (the guard kept the old
                    # params)
                    finite = bool(np.all(np.isfinite(losses))) and all(
                        bool(f) for f in torch.cat([m.finite.reshape(-1)
                                                    for m in metrics_all]).cpu()
                    ) if metrics_all else True
                n_steps = len(losses)
                dt = time.time() - t0
                history["loss"].append(float(np.mean(losses)) if losses else float("nan"))
                history["lr"].append(float(metrics_all[-1].lr.reshape(-1)[-1])
                                     if metrics_all else float("nan"))
                history["ips"].append(n_steps * rows_per_step / dt)

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


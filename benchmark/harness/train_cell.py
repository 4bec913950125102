"""A training cell: ``Trainer.fit`` on the cell's feed, on one card or one
rank of a data-parallel group.

Set-up builds one trainer and state, loads the benchmark's weights, and
drives ``fit`` from the seed through its first steps: the checked steps
(their losses, the optimizer's state after the first, the weights after
the last are kept) and a few more. The same trainer, state and feed then
run a second ``fit`` for the window: every step it issues counts, the
stop is asked once ``--seconds`` have passed, and the window ends when
``fit`` returns and the card has finished. After the window the program's
state is freed and the reference (reference/train_ref.py) follows the
checked steps from the same weights and data."""

from __future__ import annotations

import gc
import time
from typing import Dict, Optional

import numpy as np
import torch

from benchmark.harness import check, costs, inputs, program, trace
from benchmark.reference import nets, train_ref


class Recorder:
    """Wraps ``Trainer.train_step`` (the one call of every step, host feed
    and resident alike): host issue time, the step count, the snapshots of
    the checked steps, the stop at the window's end, the traced window."""

    def __init__(self, trainer, trainable, check_steps: int):
        self.trainer, self.trainable, self.check_steps = trainer, trainable, check_steps
        self.real = trainer.train_step
        self.steps = 0
        self.issue = []
        self.losses = []
        self.mu1 = None
        self.after = None
        self.stop_at_step: Optional[int] = None
        self.stop_at: Optional[float] = None
        self.tracer: Optional[trace.Window] = None
        self.trace_from = self.trace_to = None
        self.trace_seconds = 0.0
        self.trace_steps = 0
        trainer.train_step = self

    def __call__(self, state, batch):
        k = self.steps
        if k == 1:
            self.mu1 = state.opt.mu.detach().clone()
        if k == self.check_steps:
            self.after = [p.detach().clone() for p in self.trainable]
        tr = self.tracer
        now = time.perf_counter()
        if tr is not None and tr.prof is None and self.trace_from is not None \
                and now >= self.trace_from:
            tr.start()  # the profiler's own start-up is not in the window
            self.trace_to = tr.t0 + self.trace_seconds
            self.trace_steps = 0
        t = time.perf_counter()
        out = self.real(state, batch)
        self.issue.append(time.perf_counter() - t)
        if tr is not None and tr.active:
            self.trace_steps += 1
            if time.perf_counter() >= self.trace_to:
                tr.stop()
        if k < self.check_steps:
            self.losses.append(out[1].loss.detach().clone())
        self.steps += 1
        if (self.stop_at_step is not None and self.steps >= self.stop_at_step) or \
                (self.stop_at is not None and time.perf_counter() >= self.stop_at):
            self.trainer.request_stop()
        return out


class TimedFeed:
    """The host feed with the time ``fit`` waits in its ``__next__``."""

    def __init__(self, inner):
        self.inner, self.waits = inner, []

    def __iter__(self):
        return self

    def __next__(self):
        t = time.perf_counter()
        b = next(self.inner)
        self.waits.append(time.perf_counter() - t)
        return b


def _sync_all(world: int) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    if world > 1:
        torch.distributed.barrier()


def run(cell: dict, seed: int, seconds: float, traced: bool, t_start: float, parts: dict,
        world: int = 1, rank: int = 0, tmpdir: str = "/tmp", fault: Optional[str] = None,
        device: str = "cuda") -> dict:
    """One run of a training cell on this process; returns the measured
    window, the spans, the trace and the check (rank 0 assembles them)."""
    cfgd, traffic = cell["config"], cell["traffic"]
    t = time.time()
    from pldepth_torch.core import mesh as mesh_lib
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.data.datasets import DepthDataset
    from pldepth_torch.train.trainer import Trainer, trainable_params

    parts["import"] = time.time() - t
    mesh = None
    if world > 1:
        t = time.time()
        mesh = mesh_lib.current() if torch.distributed.is_initialized() else \
            mesh_lib.init_distributed(device="cpu" if device == "cpu" else None,
                                      init_method=cell["init_method"], world_size=world,
                                      rank=rank)
        parts["nccl_group"] = time.time() - t
    dev = torch.device(device, torch.cuda.current_device()) if device == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        t = time.time()
        from pldepth_torch.ops import _build

        _build.build(("listmle",))
        _build.load_library("listmle")
        parts["build_cache"] = time.time() - t

    model = cfgd["model_name"]
    size, batch = cfgd["input_size"], traffic["batch_size"]
    n_images, spe = traffic["images"], traffic["steps_per_epoch"]
    keys = set(ExperimentConfig.__dataclass_fields__)
    values = {k: v for k, v in cfgd.items() if k in keys}
    values.update(batch_size=batch, seed=seed, data_resident=traffic["feed"] == "resident",
                  resident_chain_steps=1, log_every=0, model_checkpoints=False)
    cfg = ExperimentConfig.from_dict(values)

    t = time.time()
    w = inputs.weights(seed, model, dev)
    trainer = Trainer(cfg, steps_per_epoch=spe, device=dev,
                      mesh=mesh_lib.make_mesh(cfg.mesh, mesh) if mesh else None)
    state = program.state_with(trainer, w, dev)
    trainable = trainable_params(state.model)
    train_names = [n for n, p in state.model.named_parameters() if p.requires_grad]
    parts["weights"] = time.time() - t

    t = time.time()
    data = inputs.depth_set(seed, n_images, size, dev)
    host = {k: v.cpu().numpy() for k, v in data.items()}
    del data
    items = [{k: host[k][i] for k in host} for i in range(n_images)]
    ds = DepthDataset(name="benchmark", size=n_images, loader=items.__getitem__)
    store = feed = None
    shards = trainer.mesh.data
    if cfg.data_resident:
        from pldepth_torch.data.resident import build_resident_store

        store = build_resident_store(ds, dev, shard_index=trainer.mesh.data_index,
                                     num_shards=shards)
    else:
        from pldepth_torch.data.pipeline import BatchIterator

        feed = TimedFeed(BatchIterator(ds, batch, seed=seed,
                                       prefetch=cfg.prefetch_depth, uint8_wire=cfg.uint8_wire,
                                       shard_index=trainer.mesh.data_index, num_shards=shards))
    parts["data"] = time.time() - t

    if fault is not None:
        _plant(fault, trainer)
    check_steps = traffic["check_steps"]
    rec = Recorder(trainer, trainable, check_steps)
    first_map = []  # the first step's depth maps, as the model gave them
    hook = state.model.register_forward_hook(
        lambda m, i, o: first_map.append(o.detach().float().clone()) if not first_map else None)
    t = time.time()
    rec.stop_at_step = traffic["warm_steps"]
    state, _ = trainer.fit(state, feed, resident_store=store)
    _sync_all(world)
    hook.remove()
    parts["warm_steps"] = time.time() - t
    losses = [float(x) for x in rec.losses]
    change = [(a - p).detach() for a, p in zip(rec.after, [w[n] for n in train_names])]
    mu1 = rec.mu1
    if feed is not None:
        feed.waits.clear()

    # ---- the window
    rec.stop_at_step = None
    rec.issue.clear()
    if traced:
        rec.tracer = trace.Window(tmpdir)
        rec.tracer.prime()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _sync_all(world)
    t0 = time.perf_counter()
    setup_s = time.time() - t_start
    steps0 = rec.steps
    rec.stop_at = t0 + seconds
    if traced:
        rec.trace_from = t0 + min(traffic["trace_start_s"], 0.3 * seconds)
        rec.trace_seconds = min(traffic["trace_seconds"], 0.3 * seconds)
    state, _ = trainer.fit(state, feed, resident_store=store)
    _sync_all(world)
    window_s = time.perf_counter() - t0
    steps = rec.steps - steps0
    if rec.tracer is not None and rec.tracer.active:
        rec.tracer.stop()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    out = {"kind": "train", "feed": traffic["feed"], "setup_s": setup_s, "window_s": window_s,
           "steps": steps, "images": steps * batch, "global_batch": batch, "peak_bytes": peak,
           "spans": {"step.issue": list(rec.issue),
                     "feed.next": list(feed.waits) if feed is not None else []},
           "trace": None}
    if traced and rec.tracer is not None and rec.tracer.prof is not None:
        out["trace"] = rec.tracer.read()
        out["trace"]["steps"] = rec.trace_steps
    if feed is not None:
        feed.inner.close()

    # ---- the check: the program's state freed, then the reference
    sizes = [p.numel() for p in trainable]
    grad = {n: g.view_as(p) for n, g, p in zip(train_names, (mu1 / (1 - cfg.adam_b1)).split(sizes),
                                               trainable)}
    change = dict(zip(train_names, change))
    del trainer, state, store, rec, trainable, mu1, hook
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.time()
    names = reference_names(model, cfg.freeze_encoder)
    ref = reference(cell, seed, w, host, names, world, rank, dev)
    out["check_s"] = time.time() - t
    out["numbers"] = check.train_numbers(losses, grad, change, first_map[0], ref)
    out["detail"] = check.train_detail(grad, ref)
    # the leaves the program trains and the configuration does not, or the
    # other way round (an exact comparison)
    out["numbers"]["leaves"] = float(len(set(names) ^ set(train_names)))
    out["losses"], out["ref_losses"] = losses, ref["losses"]
    out["costs"] = costs.summary(model, batch, size, cfg.freeze_encoder, cfg.rankings_per_image,
                                 cfg.ranking_size, world)
    return out


def reference_names(model: str, freeze_encoder: bool):
    """The leaves that train under the configuration's freeze rule."""
    return [name for name, _, kind, _ in nets.spec(model, 1, 32, device="cpu").spec
            if not nets.frozen(name, kind, freeze_encoder)]


def reference(cell: dict, seed: int, w: Dict[str, torch.Tensor], host: Dict[str, np.ndarray],
              names, world: int, rank: int, dev, lowp: Optional[str] = None,
              fault: Optional[str] = None) -> dict:
    """The reference's checked steps from the same weights and data (on
    every rank of a group, its own rows, sums all-reduced)."""
    cfgd, traffic = cell["config"], cell["traffic"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, batch, n = cfgd["model_name"], traffic["batch_size"], traffic["images"]
    local = batch // world
    if traffic["feed"] == "resident":
        img8, q, m8, scale = train_ref.resident_encode(host["image"], host["gt"], host["mask"])
        mine = np.arange(rank, (n // world) * world, world)
        img8, q, m8 = (torch.from_numpy(a[mine]).to(dev) for a in (img8, q, m8))
        scale_t = torch.tensor(scale, device=dev)

        def batch_of(step):
            idx = train_ref.resident_rows(seed, len(mine), local, step, dev, rank)
            return {"image": img8.index_select(0, idx).to(torch.float32) / 255.0,
                    "gt": q.index_select(0, idx) * scale_t,
                    "mask": m8.index_select(0, idx).to(torch.float32)}
    else:
        def batch_of(step):
            rows = train_ref.host_batch_rows(seed, n, local, step, world, rank)
            return {k: torch.from_numpy(host[k][rows]).to(dev) for k in ("image", "gt",
                                                                          "mask")}
    if fault == "half_batch":
        full = batch_of

        def batch_of(step):  # noqa: F811  (the fault: the mean over half the rows)
            return {k: v[: v.shape[0] // 2] for k, v in full(step).items()}
    batch_sum = grad_sum = None
    if world > 1:
        def batch_sum(t):
            from torch.distributed.nn.functional import all_reduce

            return all_reduce(t)

        def grad_sum(d):
            flat = torch.cat([v.reshape(-1) for v in d.values()])
            torch.distributed.all_reduce(flat)
            return dict(zip(d, (x.view_as(v) for x, v in zip(flat.split(
                [v.numel() for v in d.values()]), d.values()))))
    return train_ref.run_steps(model, w, names, batch_of, cfgd, seed, traffic["check_steps"],
                               traffic["steps_per_epoch"], lowp=lowp, batch_sum=batch_sum,
                               loss_scale=1.0 / world, grad_sum=grad_sum, index=rank,
                               count=world, remat=traffic.get("reference_remat", False),
                               update_sign=-1.0 if fault == "sign_flip" else 1.0)


def _plant(fault: str, trainer) -> None:
    """A fault in the timed path, for the harness's own tests."""
    if fault == "unchanged":  # a step that returns its state unchanged
        real = trainer._step

        def step(state, images, rankings):
            saved = [p.detach().clone() for p in trainable_of(state)]
            new, m = real(state, images, rankings)
            with torch.no_grad():
                for p, s in zip(trainable_of(state), saved):
                    p.copy_(s)
            return new, m

        trainer._step = step
    elif fault == "sign_flip":  # the update applied with the wrong sign
        real = trainer._step

        def step(state, images, rankings):
            saved = [p.detach().clone() for p in trainable_of(state)]
            new, m = real(state, images, rankings)
            with torch.no_grad():
                for p, s in zip(trainable_of(state), saved):
                    p.mul_(-1.0).add_(s, alpha=2.0)
            return new, m

        trainer._step = step
    elif fault == "half_batch":  # half the batch left out, the mean over the rest
        real = trainer._step

        def step(state, images, rankings):
            h = images.shape[0] // 2
            return real(state, images[:h], rankings[:h])

        trainer._step = step
    elif fault == "no_exchange":  # the gradient all-reduce left out
        object.__setattr__(trainer.mesh, "reduce_", lambda t: t)
    else:
        raise ValueError(f"unknown fault {fault!r}")


def trainable_of(state):
    return [p for p in state.model.parameters() if p.requires_grad]


def variant_numbers(cell: dict, seed: int, dev, lowp: Optional[str] = None,
                    fault: Optional[str] = None, world: int = 1, rank: int = 0) -> dict:
    """The numbers of the reference put in the program's place, computed in
    ``lowp`` or with ``fault`` planted, against the reference (this rank of
    a group's, when ``world`` > 1): the control's and the planted faults'
    readings."""
    cfgd, traffic = cell["config"], cell["traffic"]
    model = cfgd["model_name"]
    w = inputs.weights(seed, model, dev)
    data = inputs.depth_set(seed, traffic["images"], cfgd["input_size"], dev)
    host = {k: v.cpu().numpy() for k, v in data.items()}
    del data
    names = reference_names(model, cfgd["freeze_encoder"])
    ref = reference(cell, seed, w, host, names, world, rank, dev)
    got = reference(cell, seed, w, host, names, world, rank, dev, lowp=lowp, fault=fault)
    numbers = check.train_numbers(got["losses"], got["grad"], got["change"], got["map"], ref)
    numbers["leaves"] = 0.0
    return numbers

"""Process groups and the collectives of the data and model axes
(``pldepth_tpu/core/mesh.py``).

The JAX package lays its devices out as a (data, model) mesh and lets XLA
insert every cross-device reduction. Here one process drives one card and
the reductions are explicit. :class:`Mesh` holds the process group and this
rank's place in the layout: rank ``r`` sits at data index ``r // model`` and
model index ``r % model``, the order of ``np.asarray(devices).reshape(data,
model)``. Every reduction that the train step makes goes through its
helpers, so at world size W the step computes what the single-process step
computes on the global batch:

* :meth:`Mesh.sum` is a differentiable all-reduce sum over the world whose
  backward all-reduces the cotangent (batch-norm statistics over the global
  batch: SyncBN's forward and backward);
* :meth:`Mesh.reduce_` all-reduces in place without gradient (the flat
  gradient, a loss), :meth:`Mesh.max` the maxima (calibration ``amax``,
  ``gt_max``), :meth:`Mesh.broadcast_` copies rank 0's tensors;
* the model axis (spatial sharding: image rows over the ``model`` ranks of
  one data index; ops/halo.py): :meth:`Mesh.model_sum` (differentiable,
  the squeeze-excite means), :meth:`Mesh.model_gather` (the halo edges)
  and :meth:`Mesh.gather_rows` (a differentiable row all-gather: the
  prediction map the loss reads, the gt and mask the sampler reads). Each
  data index has its own model subgroup; every rank creates every
  subgroup, in the same order (:func:`make_mesh`);
* :meth:`Mesh.any` and :meth:`Mesh.barrier` are the control plane (the
  stop flag, checkpoint writes). They run on host tensors over a gloo group,
  so they never wait for the card's stream.

With no process group every helper is the identity and costs nothing.

The backend is NCCL when every rank of the host has a card of its own and
gloo otherwise (ranks that share a card, or the CPU). Gloo takes host
tensors here: a collective on a CUDA tensor is staged through host memory
(copy out, reduce, copy back). That is the transport of the shared-card
mode, chosen at start-up and printed on rank 0, not a fallback.

The step's random draws (flip, ranking sampling, drop-path) are made at the
global batch's shape and each rank keeps the rows of its data index
(:class:`RowsGenerator`), so global row i gets the same draws at every
layout as at world 1, and the model ranks of one data index draw alike.
Every draw's shape depends on the batch size only.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from pldepth_torch.core.config import MeshConfig
from pldepth_torch.core.device import local_cuda_index
from pldepth_torch.obs.spans import span


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One process's place in the job. ``group`` is None without a process
    group (world 1, every helper the identity); ``host_group`` is the gloo
    group of the control plane (``group`` itself under gloo). ``data`` x
    ``model`` = ``world``; ``model_group`` is the subgroup of the ``model``
    ranks that share this rank's data index (None when ``model`` is 1)."""

    world: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    group: Optional[object] = None
    host_group: Optional[object] = None
    data: int = 1
    model: int = 1
    model_group: Optional[object] = None

    @property
    def active(self) -> bool:
        return self.group is not None

    @property
    def staged(self) -> bool:
        """gloo carries host tensors: CUDA tensors go through host memory."""
        return self.backend == "gloo"

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def model_active(self) -> bool:
        return self.model_group is not None

    # -- data plane -------------------------------------------------------
    def _all_reduce(self, t: torch.Tensor, op, group=None) -> torch.Tensor:
        """All-reduce ``t`` in place over ``group`` (default: the world),
        staged through the host under gloo."""
        group = self.group if group is None else group
        with span("mesh.all_reduce"):
            if self.staged and t.device.type != "cpu":
                host = t.cpu()
                dist.all_reduce(host, op=op, group=group)
                t.copy_(host)
            else:
                dist.all_reduce(t, op=op, group=group)
        return t

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable all-reduce sum over the ranks; the backward
        all-reduces the cotangent. The identity with no group."""
        if not self.active:
            return x
        return _AllReduceSum.apply(x, self, self.group)

    @torch.no_grad()
    def reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place all-reduce sum without gradient."""
        return self._all_reduce(t, dist.ReduceOp.SUM) if self.active else t

    @torch.no_grad()
    def max(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce max of a copy of ``t``."""
        return self._all_reduce(t.clone(), dist.ReduceOp.MAX) if self.active else t

    @torch.no_grad()
    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Overwrite ``tensors`` with rank 0's, one flat buffer per dtype."""
        if not self.active:
            return
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in ts])
            if self.staged and flat.device.type != "cpu":
                host = flat.cpu()
                dist.broadcast(host, src=0, group=self.group)
                flat.copy_(host)
            else:
                dist.broadcast(flat, src=0, group=self.group)
            for t, v in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(v.view_as(t))

    # -- model axis ---------------------------------------------------------
    def model_sum(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`sum` over the model ranks of this data index."""
        if not self.model_active:
            return x
        return _AllReduceSum.apply(x, self, self.model_group)

    @torch.no_grad()
    def model_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(model, *t.shape): every model rank's ``t`` (equal shapes) in
        model-index order. Two-byte floats travel as their bytes (the
        gather adds nothing, and gloo's all-gather takes no 16-bit type)."""
        if not self.model_active:
            return t.unsqueeze(0)
        t = t.contiguous()
        wire = t.view(torch.uint8) if t.dtype in (torch.bfloat16, torch.float16) else t
        if self.staged and wire.device.type != "cpu":
            wire = wire.cpu()
        parts = [torch.empty_like(wire) for _ in range(self.model)]
        dist.all_gather(parts, wire, group=self.model_group)
        out = torch.stack(parts).to(t.device)
        return out.view(t.dtype) if out.dtype != t.dtype else out

    def gather_rows(self, x: torch.Tensor, counts: Sequence[int], dim: int = 1) -> torch.Tensor:
        """The model ranks' pieces of ``x`` along ``dim`` (rank q holds
        ``counts[q]`` of them), concatenated in model-index order. The
        backward sums the cotangent over the model ranks and keeps this
        rank's slice. ``requires_grad`` decides whether it is recorded."""
        if not self.model_active:
            return x
        return _GatherRows.apply(x, self, tuple(counts), dim)

    # -- control plane (host tensors, gloo) --------------------------------
    def any(self, flag: bool) -> bool:
        """True on every rank if ``flag`` is True on any rank."""
        if not self.active:
            return bool(flag)
        with span("mesh.stop"):
            t = torch.tensor([1 if flag else 0], dtype=torch.int32)
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
            return bool(t.item())

    def max_float(self, value: float) -> float:
        """The largest of every rank's ``value`` (host)."""
        if not self.active:
            return float(value)
        t = torch.tensor([value], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return float(t.item())

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` (picklable) on every rank."""
        if not self.active:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.host_group)
        return box[0]

    def barrier(self) -> None:
        if self.active:
            dist.all_reduce(torch.zeros(1), group=self.host_group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh, group):
        ctx.mesh, ctx.group = mesh, group
        return mesh._all_reduce(x.clone(), dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = ctx.mesh._all_reduce(g.contiguous().clone(), dist.ReduceOp.SUM, ctx.group)
        return g, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh, counts: Tuple[int, ...], dim: int):
        ctx.mesh, ctx.counts, ctx.dim = mesh, counts, dim
        most = max(counts)
        pad = [0, 0] * (x.dim() - 1 - dim) + [0, most - x.shape[dim]]
        parts = mesh.model_gather(F.pad(x, pad) if most > x.shape[dim] else x)
        return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, counts)], dim=dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        mesh, counts = ctx.mesh, ctx.counts
        g = mesh._all_reduce(g.contiguous().clone(), dist.ReduceOp.SUM, mesh.model_group)
        start = sum(counts[:mesh.model_index])
        return g.narrow(ctx.dim, start, counts[mesh.model_index]), None, None, None


_PROCESS_MESH: Optional[Mesh] = None
# (data, model) -> this rank's model subgroup, made once per process group
_MODEL_GROUPS: dict = {}


def current() -> Mesh:
    """The process's mesh: the one :func:`init_distributed` made, else a
    world of one with no group."""
    return _PROCESS_MESH if _PROCESS_MESH is not None else Mesh()


def init_distributed(device: Optional[str] = None, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     timeout_s: float = 600.0) -> Mesh:
    """Join the process group and return this process's :class:`Mesh`.

    Rank and world size come from the arguments, else from torchrun's
    ``RANK`` / ``WORLD_SIZE`` (``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` pick the
    card); the rendezvous from ``init_method``, else ``env://``
    (``MASTER_ADDR`` / ``MASTER_PORT``). ``device="cpu"`` runs on the CPU
    over gloo; otherwise the rank's card is ``cuda:(LOCAL_RANK %
    device_count)``, and the backend is NCCL when every local rank has a
    card of its own, gloo when ranks share one. A group that cannot form
    raises."""
    global _PROCESS_MESH
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    if device == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "(CLI: --device cpu) to run on the CPU")
        dev = torch.device("cuda", local_cuda_index())
        torch.cuda.set_device(dev)
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        backend = "nccl" if local_world <= torch.cuda.device_count() else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    group = dist.group.WORLD
    host_group = group if backend == "gloo" else dist.new_group(backend="gloo")
    _PROCESS_MESH = Mesh(world=world, rank=rank, device=dev, backend=backend, group=group,
                         host_group=host_group, data=world, model=1)
    if rank == 0:
        how = (" (collectives on CUDA tensors staged through host memory)"
               if backend == "gloo" and dev.type == "cuda" else "")
        print(f"process group: {world} rank(s), backend {backend} on {dev}{how}", flush=True)
    return _PROCESS_MESH


def shutdown() -> None:
    """Leave the process group (the counterpart of :func:`init_distributed`)."""
    global _PROCESS_MESH
    if dist.is_initialized():
        dist.destroy_process_group()
    _PROCESS_MESH = None
    _MODEL_GROUPS.clear()


def make_mesh(cfg: Optional[MeshConfig] = None, mesh: Optional[Mesh] = None) -> Mesh:
    """``mesh`` (default: the process's) laid out as ``cfg``; raises as the
    JAX package does when data x model is not the world size. With a
    process group and ``model`` > 1 every rank joins the creation of every
    data index's model subgroup (the same calls in the same order on every
    rank: ``new_group`` is collective over the world), once per layout."""
    cfg = cfg or MeshConfig()
    base = mesh if mesh is not None else current()
    data = cfg.resolved_data(base.world)
    if data * cfg.model != base.world:
        raise ValueError(f"mesh {data}x{cfg.model} does not match {base.world} devices")
    group = None
    if base.active and cfg.model > 1:
        key = (data, cfg.model)
        if key not in _MODEL_GROUPS:
            for d in range(data):
                ranks = list(range(d * cfg.model, (d + 1) * cfg.model))
                g = dist.new_group(ranks, backend=base.backend)
                if base.rank in ranks:
                    _MODEL_GROUPS[key] = g
        group = _MODEL_GROUPS[key]
    return dataclasses.replace(base, data=data, model=cfg.model, model_group=group)


def warmup_collectives(mesh: Mesh) -> float:
    """One small all-reduce of ones over the data axis, right after the
    group forms (the JAX package's guard against a communicator set up
    after a long first step); returns the data-axis length."""
    t = torch.ones(1, device=mesh.device)
    mesh.reduce_(t)
    return float(t.item()) if mesh.active else float(mesh.data)


def round_batch(batch_size: int, mesh: Mesh) -> int:
    """Round a dispatch batch up to a multiple of the data-axis size."""
    n = mesh.data
    return ((batch_size + n - 1) // n) * n


def pad_to_batch(a: np.ndarray, batch_size: int, fill: float = 0.0) -> np.ndarray:
    """Pad the leading axis up to ``batch_size`` with ``fill``."""
    pad = batch_size - a.shape[0]
    if pad <= 0:
        return a
    return np.concatenate([a, np.full((pad, *a.shape[1:]), fill, a.dtype)])


def shard_batch(mesh: Mesh, batch, rows: Optional[Tuple[int, int]] = None):
    """This rank's part of a global host batch: the contiguous block
    ``data_index`` of ``data`` equal blocks of the leading axis (the rows a
    batch-sharded array places on that data-axis index) and, with ``rows``
    (spatial sharding: this rank's image rows ``[start, end)``), those rows
    of "image", "gt" and "mask"."""
    def block(k, x):
        n = x.shape[0]
        if n % mesh.data:
            raise ValueError(f"batch of {n} rows does not split over {mesh.data} ranks")
        b = n // mesh.data
        x = x[mesh.data_index * b:(mesh.data_index + 1) * b]
        if rows is not None and k in ("image", "gt", "mask"):
            x = x[:, rows[0]:rows[1]]
        return x

    return {k: block(k, v) for k, v in batch.items()}


class RowsGenerator:
    """A ``torch.Generator`` whose batch draws (:func:`batch_rand`,
    :func:`batch_randint`) are made at the global batch's shape, ``count``
    times the local rows, of which this rank keeps block ``index`` (the
    data index and the data-axis size: every model rank of a data index
    draws alike)."""

    def __init__(self, gen: torch.Generator, index: int = 0, count: int = 1):
        self.gen, self.index, self.count = gen, index, count

    @property
    def device(self) -> torch.device:
        return self.gen.device

    def get_state(self) -> torch.Tensor:
        return self.gen.get_state()

    def with_state(self, state: torch.Tensor) -> "RowsGenerator":
        """A new generator of the same kind set to ``state``."""
        g = torch.Generator(device=self.gen.device)
        g.set_state(state)
        return RowsGenerator(g, self.index, self.count)

    def set_state(self, state: torch.Tensor) -> None:
        self.gen.set_state(state)

    def rows(self, full: torch.Tensor, b: int) -> torch.Tensor:
        return full if self.count == 1 else full.narrow(0, self.index * b, b)


def _global(gen, shape: Sequence[int]):
    """(the torch generator, the shape to draw, the local row count)."""
    shape = tuple(shape)
    if isinstance(gen, RowsGenerator):
        return gen.gen, (shape[0] * gen.count, *shape[1:]), shape[0]
    return gen, shape, shape[0]


def batch_rand(gen, shape: Sequence[int], device=None) -> torch.Tensor:
    """``torch.rand(shape)`` with the batch on the leading axis; a
    :class:`RowsGenerator` draws the global batch and keeps its rows."""
    g, full, b = _global(gen, shape)
    out = torch.rand(full, generator=g, device=device)
    return gen.rows(out, b) if isinstance(gen, RowsGenerator) else out


def batch_randint(gen, high: int, shape: Sequence[int], device=None) -> torch.Tensor:
    """``torch.randint(0, high, shape)``, drawn as :func:`batch_rand`."""
    g, full, b = _global(gen, shape)
    out = torch.randint(0, high, full, generator=g, device=device)
    return gen.rows(out, b) if isinstance(gen, RowsGenerator) else out


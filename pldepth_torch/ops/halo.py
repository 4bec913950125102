"""Spatial sharding's rows: the row partition of every level and the halo
exchange (the JAX package's ``--spatial_sharding``, where XLA's SPMD
partitioner inserts both).

Under spatial sharding the ``model`` ranks of one data index each hold a
contiguous range of image rows at every level of the network (level 0 the
input, level l after l stride-2 steps). The partition is nested: the rows of
the deepest level are split over the ranks as ``ceil(rows / M)`` a rank, and
each level above holds twice the range of the level below, clipped to its
height. A stride-2 SAME conv then maps a rank's rows ``[a, b)`` at level l to
``[a/2, b/2)`` at level l+1 and the decoder's 2x upsample maps them back,
so the upsampled rows and the encoder tap that the decoder concatenates
with them are the same rows on every rank. Ranges may be uneven or empty
(ff_smoke at 64^2 and M = 4: the deepest level has 2 rows, ranks 2 and 3
own nothing); an empty rank still joins every collective.

An op that reads across rows (a k x k conv, the bilinear 2x upsample, the
fused decoder tail) needs some rows of its neighbours: its *halo*.
:func:`halo_plan` says, for every rank, which input rows its output rows
read (a pure function of the partition, so every rank knows every rank's
plan and the CPU tests check it in one process); :func:`extend_rows` fetches
them. The transport is one all-gather over the model group of each rank's
first and last ``h`` rows, padded to ``h`` (``h`` the largest halo of any
rank): a rank assembles what it needs from those edges even across a
neighbour that owns fewer than ``h`` rows, with no send/recv pairs to order,
the same under gloo and NCCL. Its backward is the adjoint: the halo rows'
cotangents are all-gathered the same way and added into their owners' rows.
Rows outside the image are left to the op's border rule (zeros for SAME
padding, the edge clamp for the upsample).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

Span = Tuple[int, int]


def level_heights(h: int, levels: int) -> Tuple[int, ...]:
    """Rows of levels 0..``levels``: ``h``, then ``ceil(/2)`` each step (SAME
    stride 2)."""
    out = [int(h)]
    for _ in range(levels):
        out.append(-(-out[-1] // 2))
    return tuple(out)


def row_partition(heights: Sequence[int], m: int) -> Tuple[Tuple[Span, ...], ...]:
    """``parts[level][q]``: rank q's rows ``(start, end)`` of each level, the
    nested partition of the module docstring."""
    depth = len(heights) - 1
    chunk = -(-heights[-1] // m)
    return tuple(
        tuple((min(q * chunk << (depth - lvl), h), min((q + 1) * chunk << (depth - lvl), h))
              for q in range(m))
        for lvl, h in enumerate(heights))


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's rows of the network at one ``level``: the global heights
    of every level, the partition (:func:`row_partition`), the rank's model
    index and the mesh whose model group exchanges halos (None: no
    exchange, the one-process tests). The forward of a spatially sharded
    module takes one of these (``rows``) beside its input."""

    heights: Tuple[int, ...]
    parts: Tuple[Tuple[Span, ...], ...]
    index: int
    level: int = 0
    mesh: Optional[object] = None  # core/mesh.py Mesh

    @classmethod
    def for_mesh(cls, mesh, height: int, levels: int) -> "RowShard":
        heights = level_heights(height, levels)
        return cls(heights, row_partition(heights, mesh.model), mesh.model_index, 0, mesh)

    @property
    def height(self) -> int:
        return self.heights[self.level]

    @property
    def span(self) -> Span:
        return self.parts[self.level][self.index]

    @property
    def counts(self) -> Tuple[int, ...]:
        """Rows of each rank at this level."""
        return tuple(e - s for s, e in self.parts[self.level])

    def at(self, level: int) -> "RowShard":
        return dataclasses.replace(self, level=level)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole image's rows of ``x`` (rows on dim 1) on every model
        rank; differentiable when ``x`` requires grad."""
        return self.mesh.gather_rows(x, self.counts, dim=1)


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """The input rows each rank's output rows read. ``parts``: every rank's
    own input rows; ``need``: every rank's clipped input range (None for a
    rank with no output rows); ``lo`` / ``hi``: the unclipped range (rows
    outside ``[0, height)`` are the op's border); ``h``: the edge depth the
    exchange carries (0: no exchange)."""

    parts: Tuple[Span, ...]
    height: int
    need: Tuple[Optional[Span], ...]
    lo: Tuple[int, ...]
    hi: Tuple[int, ...]
    h: int

    def top(self, q: int) -> int:
        """Rows rank q reads above its own (negative: it skips its first)."""
        return 0 if self.need[q] is None else self.parts[q][0] - self.need[q][0]

    def bottom(self, q: int) -> int:
        return 0 if self.need[q] is None else self.need[q][1] - self.parts[q][1]


def halo_plan(parts_in: Sequence[Span], parts_out: Sequence[Span], height: int,
              read: Callable[[int, int], Span]) -> HaloPlan:
    """The plan of an op whose output rows ``[so, eo)`` read input rows
    ``read(so, eo)`` (unclipped) of an input of ``height`` rows."""
    need, lo, hi = [], [], []
    for s, e in parts_out:
        if e > s:
            a, b = read(s, e)
            need.append((max(a, 0), min(b, height)))
        else:
            a = b = 0
            need.append(None)
        lo.append(a)
        hi.append(b)
    h = 0
    for q, (s, e) in enumerate(parts_in):
        if need[q] is not None:
            h = max(h, s - need[q][0], need[q][1] - e)
    return HaloPlan(tuple(parts_in), height, tuple(need), tuple(lo), tuple(hi), h)


# -- the edges and their assembly (pure: the CPU tests call these directly) --
def edges(x: torch.Tensor, h: int) -> torch.Tensor:
    """(B, 2h, ...): ``x``'s first ``h`` rows (zero rows after them where it
    has fewer), then its last ``h`` (zero rows before them)."""
    n = x.shape[1]
    k = min(h, n)
    zeros = x.new_zeros((x.shape[0], h - k, *x.shape[2:]))
    return torch.cat([x[:, :k], zeros, zeros, x[:, n - k:]], dim=1)


def assemble(x: torch.Tensor, stacks: torch.Tensor, plan: HaloPlan, q: int) -> torch.Tensor:
    """Rank ``q``'s rows ``need[q]`` from its own ``x`` and every rank's
    :func:`edges` (``stacks``: (M, B, 2h, ...)). Rows above its own come
    from the ranks before it (their last ``h`` rows), rows below from the
    ranks after it (their first ``h``)."""
    need = plan.need[q]
    if need is None:
        return x[:, :0].clone()
    s, e = plan.parts[q]
    h = plan.h
    pieces = []
    for r, (sr, er) in enumerate(plan.parts):  # rows above: [need0, s)
        a, b = max(need[0], sr), min(s, er)
        if r < q and b > a:
            pieces.append(stacks[r, :, 2 * h - (er - a):2 * h - (er - b)])
    a, b = max(need[0], s), min(need[1], e)
    if b > a:
        pieces.append(x[:, a - s:b - s])
    for r, (sr, er) in enumerate(plan.parts):  # rows below: [e, need1)
        a, b = max(e, sr), min(need[1], er)
        if r > q and b > a:
            pieces.append(stacks[r, :, a - sr:b - sr])
    out = torch.cat(pieces, dim=1) if pieces else x[:, :0]
    if out.shape[1] != need[1] - need[0]:
        raise RuntimeError(f"rank {q}: assembled {out.shape[1]} rows of {need}")
    return out


def halo_cotangents(g: torch.Tensor, plan: HaloPlan, q: int) -> torch.Tensor:
    """(B, 2h, ...): the cotangents of rank ``q``'s rows above its own
    (padded after them to ``h``), then of its rows below (padded after)."""
    h = plan.h
    top, bottom = max(plan.top(q), 0), max(plan.bottom(q), 0)
    n = g.shape[1]
    zeros = lambda k: g.new_zeros((g.shape[0], k, *g.shape[2:]))  # noqa: E731
    return torch.cat([g[:, :top], zeros(h - top), g[:, n - bottom:], zeros(h - bottom)], dim=1)


def own_cotangent(g: torch.Tensor, stacks: torch.Tensor, plan: HaloPlan, q: int,
                  n_own: int) -> torch.Tensor:
    """The cotangent of rank ``q``'s own rows: its part of ``g`` (the
    cotangent of ``need[q]``) plus every rank's halo cotangents
    (:func:`halo_cotangents`, ``stacks``) that fall on its rows."""
    s, e = plan.parts[q]
    out = g.new_zeros((g.shape[0], n_own, *g.shape[2:]))
    need = plan.need[q]
    if need is not None:
        a, b = max(need[0], s), min(need[1], e)
        if b > a:
            out[:, a - s:b - s] += g[:, a - need[0]:b - need[0]]
    h = plan.h
    for r in range(len(plan.parts)):
        if r == q or plan.need[r] is None:
            continue
        sr, er = plan.parts[r]
        t0 = sr - max(plan.top(r), 0)  # rank r's top halo: rows [t0, sr)
        a, b = max(t0, s), min(sr, e)
        if b > a:
            out[:, a - s:b - s] += stacks[r, :, a - t0:b - t0]
        a, b = max(er, s), min(er + max(plan.bottom(r), 0), e)  # bottom: [er, ...)
        if b > a:
            out[:, a - s:b - s] += stacks[r, :, h + a - er:h + b - er]
    return out


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh, plan: HaloPlan, q: int):
        ctx.mesh, ctx.plan, ctx.q, ctx.n = mesh, plan, q, x.shape[1]
        return assemble(x, mesh.model_gather(edges(x, plan.h)), plan, q)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        plan, q = ctx.plan, ctx.q
        stacks = ctx.mesh.model_gather(halo_cotangents(g.contiguous(), plan, q))
        return own_cotangent(g, stacks, plan, q, ctx.n), None, None, None


def extend_rows(x: torch.Tensor, rows: RowShard, plan: HaloPlan) -> torch.Tensor:
    """``x`` (this rank's rows, dim 1) extended to the rows its output reads,
    ``plan.need[rows.index]`` (clipped to the image). Every rank calls this
    with the same plan: the exchange is a collective (none when ``h`` is 0,
    as for a 1 x 1 conv)."""
    q = rows.index
    if plan.h == 0:
        if plan.need[q] is None:
            return x[:, :0]
        s = plan.parts[q][0]
        a, b = plan.need[q]
        return x[:, a - s:b - s]
    return _Halo.apply(x, rows.mesh, plan, q)


def abs_max(x: torch.Tensor) -> torch.Tensor:
    """max |x| as a scalar of x's dtype, 0 for a tensor with no elements (a
    rank of a spatially sharded step that owns no rows; ``amax`` refuses
    those)."""
    return x.abs().amax() if x.numel() else x.new_zeros(())


def extend_from_full(full: torch.Tensor, plan: HaloPlan, q: int) -> torch.Tensor:
    """Rank ``q``'s extended rows cut from the whole tensor: what
    :func:`extend_rows` returns (the one-process tests' stand-in for the
    exchange)."""
    need = plan.need[q]
    return full[:, :0] if need is None else full[:, need[0]:need[1]]

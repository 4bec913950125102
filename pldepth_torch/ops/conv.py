"""TF/lax SAME convolution on NHWC tensors.

``padding="SAME"`` in lax pads ``max((out-1)*stride + k - size, 0)`` in
total with the smaller half before: asymmetric at stride 2 on even sizes,
so ``padding=k//2`` would be wrong there. A conv built with an explicit
``padding`` (the ResNet stem's ``((3, 3), (3, 3))``) pads that much on
every side instead.

Under spatial sharding (``rows``, an ops/halo.py ``RowShard``) the input
holds one rank's rows of the image: the pads come from the image's global
height, a rank's interior sides read its neighbours' rows (the halo), and
its output rows are its rows of the output level. :func:`max_pool3x3s2`
(the ResNet stem's 3x3 stride-2 max pool, padded by 1 with -inf) runs
row-sharded the same way, its rows outside the image -inf, not 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from pldepth_torch.ops.halo import HaloPlan, RowShard, extend_rows, halo_plan


def same_out_and_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """SAME output size ``ceil(size/stride)`` and the pad before it."""
    out = -(-size // stride)
    return out, max((out - 1) * stride + k - size, 0) // 2


def same_pads(h: int, w: int, k: int, stride: int) -> Tuple[int, int, int, int]:
    """(left, right, top, bottom) SAME pads of an (h, w) image."""
    ho, pt = same_out_and_pad(h, k, stride)
    wo, pl = same_out_and_pad(w, k, stride)
    pb = max((ho - 1) * stride + k - h, 0) - pt
    pr = max((wo - 1) * stride + k - w, 0) - pl
    return pl, pr, pt, pb


def conv_pads(h: int, w: int, k: int, stride: int,
              padding: Optional[int] = None) -> Tuple[int, int, int, int]:
    """(left, right, top, bottom) pads: SAME's where ``padding`` is None,
    else ``padding`` on every side."""
    if padding is None:
        return same_pads(h, w, k, stride)
    return (padding,) * 4


def conv2d_same_nhwc(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
                     groups: int = 1, padding: Optional[int] = None,
                     rows: Optional[RowShard] = None) -> torch.Tensor:
    """SAME (or explicitly padded) convolution of NHWC ``x`` with an OIHW
    ``weight`` of x's dtype. With ``rows`` (x's level), ``x`` is this
    rank's rows and so is the result."""
    if rows is not None:
        plan = conv_row_plan(rows, weight.shape[-1], stride, padding)
        return conv2d_rows_local(extend_rows(x, rows, plan), weight, stride, groups, padding,
                                 plan, rows.index)
    if x.shape[1] == 0:  # a sharded rank with no rows: k zero rows in, none out
        k = weight.shape[-1]
        pl, pr, _, _ = conv_pads(k, x.shape[2], k, stride, padding)
        y = F.conv2d(F.pad(x, (0, 0, pl, pr, k, 0)).permute(0, 3, 1, 2), weight, None, stride,
                     0, 1, groups)
        return y.permute(0, 2, 3, 1).narrow(1, 0, 0)
    pads = conv_pads(x.shape[1], x.shape[2], weight.shape[-1], stride, padding)
    if any(pads):
        x = F.pad(x, (0, 0, *pads))
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, None, stride, 0, 1, groups)
    return y.permute(0, 2, 3, 1)


def conv_row_plan(rows: RowShard, k: int, stride: int,
                  padding: Optional[int] = None) -> HaloPlan:
    """The halo plan of a k x k conv at ``rows``' level: output rows
    ``[so, eo)`` (the ranks' rows of the next level at stride 2) read input
    rows ``[so * stride - pad_top, (eo - 1) * stride - pad_top + k)``, the
    top pad that of the global height."""
    if stride not in (1, 2):
        raise ValueError(f"a row-sharded conv has stride 1 or 2, not {stride}")
    h = rows.height
    pt = same_out_and_pad(h, k, stride)[1] if padding is None else padding
    return halo_plan(rows.parts[rows.level], rows.parts[rows.level + stride - 1], h,
                     lambda so, eo: (so * stride - pt, (eo - 1) * stride - pt + k))


def row_pads(plan: HaloPlan, q: int, width: int, k: int, stride: int,
             padding: Optional[int] = None) -> Tuple[int, int, int, int]:
    """(left, right, top, bottom) pads of rank ``q``'s input rows
    ``plan.need[q]`` for a k x k window: the whole image's column pads, and
    a row of pad for each row of the read outside the image; a rank with no
    output rows reads k rows of pad and keeps no output row."""
    pl, pr, _, _ = conv_pads(plan.height, width, k, stride, padding)
    if plan.need[q] is None:
        return pl, pr, k, 0
    return pl, pr, max(0, -plan.lo[q]), max(0, plan.hi[q] - plan.height)


def conv2d_rows_local(ext: torch.Tensor, weight: torch.Tensor, stride: int, groups: int,
                      padding: Optional[int], plan: HaloPlan, q: int) -> torch.Tensor:
    """Rank ``q``'s output rows from ``ext``, the input rows they read
    (``plan.need[q]``): zero rows where those lie outside the image, the
    width padded as the whole image's (:func:`row_pads`). A rank with no
    output rows convolves k zero rows and keeps none of the result, so its
    graph holds the same collectives as every other rank's."""
    pads = row_pads(plan, q, ext.shape[2], weight.shape[-1], stride, padding)
    x = F.pad(ext, (0, 0, *pads))
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, None, stride, 0, 1, groups).permute(0, 2, 3, 1)
    return y.narrow(1, 0, 0) if plan.need[q] is None else y


def max_pool3x3s2(x: torch.Tensor, rows: Optional[RowShard] = None) -> torch.Tensor:
    """3x3 stride-2 max pool of NHWC ``x`` padded by 1 with -inf (flax
    ``nn.max_pool(x, (3, 3), (2, 2), ((1, 1), (1, 1)))``). With ``rows``
    (x's level), ``x`` is this rank's rows and the result its rows of the
    next level."""
    if rows is not None:
        plan = pool_row_plan(rows)
        return max_pool_rows_local(extend_rows(x, rows, plan), plan, rows.index)
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def pool_row_plan(rows: RowShard) -> HaloPlan:
    """The max pool's halo plan: output rows ``[so, eo)`` read input rows
    ``[2 so - 1, 2 eo)``, the plan of a 3 x 3 stride-2 conv padded by 1."""
    return conv_row_plan(rows, 3, 2, 1)


def max_pool_rows_local(ext: torch.Tensor, plan: HaloPlan, q: int) -> torch.Tensor:
    """Rank ``q``'s rows of :func:`max_pool3x3s2` from ``ext``
    (``plan.need[q]``): -inf rows where those lie outside the image, the
    columns padded by 1 with -inf as the whole image's. A rank with no
    output rows pools 3 rows of -inf and keeps none (``F.max_pool2d`` takes
    no zero-row input)."""
    _, _, zt, zb = row_pads(plan, q, ext.shape[2], 3, 2, 1)
    x = F.pad(ext, (0, 0, 0, 0, zt, zb), value=float("-inf")) if zt or zb else ext
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, (0, 1)).permute(0, 2, 3, 1)
    return y.narrow(1, 0, 0) if plan.need[q] is None else y

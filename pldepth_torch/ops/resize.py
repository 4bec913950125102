"""Resizing with TF2 / ``jax.image.resize`` semantics, NHWC at the interface.

The JAX package resizes with ``jax.image.resize(method='bilinear',
antialias=False)`` (``pldepth_tpu/ops/resize.py``): half-pixel centres and
edge clamping, the grid of ``tf.image.resize`` and Keras
``UpSampling2D(interpolation='bilinear')``. ``F.interpolate`` with
``align_corners=False, antialias=False`` samples the same grid
(tests/test_torch_resize.py holds it against tests/golden/tf_resize.npz).
``jax.image.resize(..., "nearest")`` samples source pixel
``floor((i + 0.5) * in / out)``: ``F.interpolate``'s ``"nearest-exact"``,
not its ``"nearest"`` (``floor(i * in / out)``).

:func:`upsample2x_bilinear` runs row-sharded (``rows``, ops/halo.py): a
rank reads one row of each neighbour and clamps only at the image's own
top and bottom.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from pldepth_torch.ops.halo import HaloPlan, RowShard, extend_rows, halo_plan


def resize_bilinear(img: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C) to (..., size[0], size[1], C)."""
    lead = img.shape[:-3]
    h, w, c = img.shape[-3:]
    x = img.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(int(size[0]), int(size[1])), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, int(size[0]), int(size[1]), c)


def resize_nearest(img: torch.Tensor, size: Sequence[int],
                   channel_last: bool = True) -> torch.Tensor:
    """Nearest-neighbor resize (masks; reference hr_wsi.py:73-74).

    2-D inputs are (H, W). Higher ranks are (..., H, W, C) by default; a
    batched channel-less mask stack (B, H, W) must pass
    ``channel_last=False`` -- silently treating it as (H, W, C) would
    resample the batch axis and leave W untouched."""
    out_hw = (int(size[0]), int(size[1]))
    if img.dim() == 2 or not channel_last:
        lead, (h, w) = img.shape[:-2], img.shape[-2:]
        y = F.interpolate(img.reshape(-1, 1, h, w), size=out_hw, mode="nearest-exact")
        return y.reshape(*lead, *out_hw)
    lead = img.shape[:-3]
    h, w, c = img.shape[-3:]
    x = img.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=out_hw, mode="nearest-exact")
    return y.permute(0, 2, 3, 1).reshape(*lead, *out_hw, c)


def upsample2x_bilinear(x: torch.Tensor, rows: Optional[RowShard] = None) -> torch.Tensor:
    """Keras UpSampling2D(interpolation='bilinear') equivalent, NHWC. With
    ``rows`` (x's level), ``x`` is this rank's rows and the result its rows
    of the level above."""
    if rows is not None:
        plan = upsample_row_plan(rows)
        return upsample2x_rows_local(extend_rows(x, rows, plan), plan, rows.index)
    n, h, w, c = x.shape
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(2 * h, 2 * w),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


def upsample_row_plan(rows: RowShard) -> HaloPlan:
    """Output rows ``[2a, 2b)`` read input rows ``[a - 1, b + 1)``: half-pixel
    output row ``2i`` mixes input rows ``i - 1`` and ``i``, row ``2i + 1``
    rows ``i`` and ``i + 1``."""
    lvl = rows.level
    if rows.heights[lvl - 1] != 2 * rows.height:
        raise ValueError(f"a row-sharded 2x upsample needs level {lvl - 1} to be twice level "
                         f"{lvl}: {rows.heights[lvl - 1]} vs {rows.height}")
    return halo_plan(rows.parts[lvl], rows.parts[lvl - 1], rows.height,
                     lambda so, eo: (so // 2 - 1, -(-eo // 2) + 1))


def upsample2x_rows_local(ext: torch.Tensor, plan: HaloPlan, q: int) -> torch.Tensor:
    """Rank ``q``'s upsampled rows from ``ext`` (``plan.need[q]``): an edge row
    repeated where the rank touches the image's border (the clamp), then
    the whole strip upsampled and its first and last two rows (the strip's
    own clamp) dropped. A rank with no rows upsamples two zero rows and
    keeps none."""
    if plan.need[q] is None:
        z = ext.new_zeros((ext.shape[0], 2, *ext.shape[2:]))
        return upsample2x_bilinear(torch.cat([ext, z], dim=1)).narrow(1, 0, 0)
    top, bottom = plan.lo[q] < 0, plan.hi[q] > plan.height
    e = torch.cat(([ext[:, :1]] if top else []) + [ext] + ([ext[:, -1:]] if bottom else []),
                  dim=1)
    return upsample2x_bilinear(e).narrow(1, 2, 2 * e.shape[1] - 4)

"""Device-resident training data (``pldepth_tpu/data/resident.py``): the
whole (image, gt, mask) set held in device memory.

The streaming feeds decode on the host and copy every batch to the card.
This workload's training sets fit in device memory (6 bytes a pixel: a 448²
sample is 1.2 MB), so the fastest feed is none: upload the set once, draw
each step's batch indices on the device and decode there
(``Trainer.resident_step``). No batch data crosses the host link per step.

Storage layout (6 bytes a pixel):
  image (N, H, W, 3) uint8   -- the wire format the train step decodes
  gt    (N, H, W)    int16   -- the bits of a uint16 q, float gt =
                                q * gt_scale, gt_scale = max(gt_max, 1e-6)
                                / 65535 (16-bit PNG gt round-trips; other
                                sources quantize to <= 7.7e-6 of the set's
                                largest value). torch's uint16 is a limited
                                type (no ``index_select``), so the store
                                holds the same 2 bytes as int16 and
                                :func:`decode_gt` reads them back unsigned
  mask  (N, H, W)    uint8
  gt_scale ()        float32 -- on the device, so the decode multiplies by
                                a tensor and not a Python float

Batches are uniform draws with replacement: the device analogue of the
reference's shuffle(1024) + repeat stream, not an epoch permutation (use
``BatchIterator`` where epoch order matters).

Data parallelism (``num_shards`` > 1, one process per card): the set is cut
to a multiple of the shard count, each rank holds the stride
``shard_index::num_shards`` of it on its card, and ``gt_max`` is the
ranks' largest (an all-reduce max over the process group) so every shard
quantizes with one ``gt_scale``; ``Trainer.resident_batch`` draws each
rank's rows from its own shard. Under a mesh model axis the shards are the
data indices (``num_shards`` = data), so the model ranks of one data index
hold the same samples; under spatial sharding (``rows``) each of them holds
only its image rows of those samples, and ``gt_max`` is the largest over
every rank's rows.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pldepth_torch.core import mesh as mesh_lib
from pldepth_torch.core.device import DeviceLike, resolve_device
from pldepth_torch.data.datasets import DepthDataset

log = logging.getLogger(__name__)

BYTES_PER_PIXEL = 6  # u8 rgb (3) + u16 gt (2) + u8 mask (1)


def estimate_store_bytes(n: int, image_size: int) -> int:
    return n * image_size * image_size * BYTES_PER_PIXEL


@dataclasses.dataclass
class ResidentStore:
    """Device tensors of a resident set: ``arrays`` holds image / gt / mask
    as the module docstring lays out, plus ``gt_scale`` as a 0-d f32 tensor;
    the field ``gt_scale`` is the same value as a Python float."""

    arrays: Dict[str, torch.Tensor]
    n: int  # the global sample count held (cut to a multiple of the shards)
    gt_scale: float

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.arrays.values())


def decode_gt(q: torch.Tensor, gt_scale: torch.Tensor) -> torch.Tensor:
    """Stored gt (int16 holding uint16 bits) -> f32: ``u16 * gt_scale``."""
    return (q.to(torch.int32) & 0xFFFF).to(torch.float32) * gt_scale


def build_resident_store(ds: DepthDataset, device: DeviceLike = None, *,
                         max_bytes: Optional[int] = None, shard_index: int = 0,
                         num_shards: int = 1,
                         rows: Optional[Tuple[int, int]] = None) -> ResidentStore:
    """Load ``ds`` on the host, quantize it, and upload it to ``device``
    (default ``cuda``). ``max_bytes`` bounds the store; a larger set
    raises, and the streaming feeds are the way to train on it.

    ``num_shards`` > 1: this process holds samples
    ``shard_index::num_shards`` of the first ``len(ds) // num_shards *
    num_shards``, and ``gt_max`` is all-reduced over the process group
    (core/mesh.py), whose world is a multiple of the shards
    (``pldepth_tpu/data/resident.py``). ``rows`` (spatial sharding): only
    image rows ``[start, end)`` of each sample, ``gt_max`` all-reduced over
    the group too (``spatial_axis`` in the JAX package)."""
    dev = resolve_device(device)
    n = (len(ds) // num_shards) * num_shards
    if n == 0:
        raise ValueError(f"dataset of {len(ds)} samples cannot shard over "
                         f"{num_shards} processes" if len(ds) else
                         "an empty dataset has no resident store")
    if n != len(ds):
        log.info("resident store: truncating %d -> %d samples for even sharding", len(ds), n)
    mesh = mesh_lib.current()
    if num_shards > 1 and mesh.world % num_shards:
        raise ValueError(f"a store of {num_shards} shards needs a process group of "
                         f"{num_shards} ranks, have {mesh.world} (a multiple of {num_shards} "
                         "under a model axis)")
    h, w = ds[0]["gt"].shape
    if max_bytes is not None and n * h * w * BYTES_PER_PIXEL > max_bytes:
        raise ValueError(
            f"resident store would need {n * h * w * BYTES_PER_PIXEL / 1e9:.1f} GB "
            f"> max_bytes {max_bytes / 1e9:.1f} GB -- use the streaming pipeline")

    local_idx = range(shard_index, n, num_shards)
    r0, r1 = (0, h) if rows is None else rows
    images = np.empty((len(local_idx), r1 - r0, w, 3), np.uint8)
    gts = np.empty((len(local_idx), r1 - r0, w), np.float32)
    masks = np.empty((len(local_idx), r1 - r0, w), np.uint8)
    for row, i in enumerate(local_idx):
        s = ds[i]
        img = s["image"][r0:r1]
        if img.dtype != np.uint8:  # [0, 1] float -> u8 (round half to even)
            img = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
        images[row] = img
        gts[row] = s["gt"][r0:r1]
        masks[row] = (s["mask"][r0:r1] > 0).astype(np.uint8)

    # one scale for every shard: the largest gt of all of them (a rank that
    # holds no rows adds nothing)
    gt_max = float(gts.max()) if gts.size else 0.0
    if num_shards > 1 or rows is not None:
        gt_max = mesh.max_float(gt_max)
    gt_max = max(gt_max, 1e-6)
    gt_scale = gt_max / 65535.0
    gt_q = np.clip(np.round(gts / gt_scale), 0, 65535).astype(np.uint16)

    arrays = {k: torch.from_numpy(x).to(dev)
              for k, x in (("image", images), ("gt", gt_q.view(np.int16)), ("mask", masks))}
    arrays["gt_scale"] = torch.tensor(gt_scale, dtype=torch.float32, device=dev)
    store = ResidentStore(arrays=arrays, n=n, gt_scale=gt_scale)
    log.info("resident store: %d samples @ %dx%d, %.2f GB on %s (gt_scale %.3e%s)",
             n, r1 - r0, w, store.nbytes / 1e9, dev, gt_scale,
             (f", shard {shard_index} of {num_shards}" if num_shards > 1 else "")
             + (f", rows {r0}:{r1}" if rows is not None else ""))
    return store

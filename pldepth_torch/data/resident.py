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
``BatchIterator`` where epoch order matters). One device: sharding the store
over several cards or processes, and over a spatial axis, is ROADMAP.md
queue 1 item 11.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional

import numpy as np
import torch

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
    n: int
    gt_scale: float

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.arrays.values())


def decode_gt(q: torch.Tensor, gt_scale: torch.Tensor) -> torch.Tensor:
    """Stored gt (int16 holding uint16 bits) -> f32: ``u16 * gt_scale``."""
    return (q.to(torch.int32) & 0xFFFF).to(torch.float32) * gt_scale


def build_resident_store(ds: DepthDataset, device: DeviceLike = None, *,
                         max_bytes: Optional[int] = None, shard_index: int = 0,
                         num_shards: int = 1) -> ResidentStore:
    """Load ``ds`` on the host, quantize it, and upload it to ``device``
    (default ``cuda``). ``max_bytes`` bounds the store; a larger set
    raises, and the streaming feeds are the way to train on it."""
    if num_shards > 1:
        raise NotImplementedError(
            "a resident store sharded over processes (num_shards > 1; the all-gather "
            "of gt_max needs a process group) is not ported yet: ROADMAP.md queue 1 item 11")
    dev = resolve_device(device)
    n = len(ds)
    if n == 0:
        raise ValueError("an empty dataset has no resident store")
    h, w = ds[0]["gt"].shape
    if max_bytes is not None and n * h * w * BYTES_PER_PIXEL > max_bytes:
        raise ValueError(
            f"resident store would need {n * h * w * BYTES_PER_PIXEL / 1e9:.1f} GB "
            f"> max_bytes {max_bytes / 1e9:.1f} GB -- use the streaming pipeline")

    images = np.empty((n, h, w, 3), np.uint8)
    gts = np.empty((n, h, w), np.float32)
    masks = np.empty((n, h, w), np.uint8)
    for i in range(n):
        s = ds[i]
        img = s["image"]
        if img.dtype != np.uint8:  # [0, 1] float -> u8 (round half to even)
            img = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
        images[i] = img
        gts[i] = s["gt"]
        masks[i] = (s["mask"] > 0).astype(np.uint8)

    gt_max = max(float(gts.max()), 1e-6)
    gt_scale = gt_max / 65535.0
    gt_q = np.clip(np.round(gts / gt_scale), 0, 65535).astype(np.uint16)

    arrays = {k: torch.from_numpy(x).to(dev)
              for k, x in (("image", images), ("gt", gt_q.view(np.int16)), ("mask", masks))}
    arrays["gt_scale"] = torch.tensor(gt_scale, dtype=torch.float32, device=dev)
    store = ResidentStore(arrays=arrays, n=n, gt_scale=gt_scale)
    log.info("resident store: %d samples @ %dx%d, %.2f GB on %s (gt_scale %.3e)",
             n, h, w, store.nbytes / 1e9, dev, gt_scale)
    return store

"""Host batch pipeline (``pldepth_tpu/data/pipeline.py``): shuffle, batch,
background prefetch; fixed validation rankings.

The host only decodes and batches raw (image, gt, mask) arrays; flip and
ranking sampling run in the train step on the device. The batch stream is
the JAX package's: epoch ``e``'s permutation comes from
``np.random.default_rng((seed, e))``, so the same dataset and seed give the
same batches in both packages, ``start_step=k`` resumes the stream at batch
``k``, and ``shard_index`` / ``num_shards`` take the same disjoint stride of
each permutation. ``uint8_wire`` sends images and masks as uint8; the train
step rescales on the device (train/trainer.py ``_to_device``).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from pldepth_torch.core.rng import generator
from pldepth_torch.data.datasets import DepthDataset
from pldepth_torch.sampling import sample_rankings_batch


def train_val_split(ds: DepthDataset, denom: int = 15) -> Tuple[DepthDataset, DepthDataset]:
    """Reference split: the first len(ds)//denom samples are validation
    (pldepth/PLDepth.py:142-147)."""
    n_val = len(ds) // denom
    return ds.skip(n_val), ds.take(n_val)


def _stack(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class BatchIterator:
    """Shuffled batch iterator with a background prefetch thread;
    drop_remainder semantics (fixed shapes only).

    ``loop=False`` ends after one epoch: ``StopIteration``, and the iterator
    stays exhausted. ``shard_index`` / ``num_shards``: every shard draws the
    same seeded epoch permutation and takes a disjoint stride of it, cut to
    the common per-shard length so all shards count the same batches.
    ``start_step``: skip the first N batches of the stream (resume).
    ``uint8_wire``: images as ``uint8(clip(x * 255 + 0.5))`` and masks as
    ``uint8(mask > 0)``, gt stays f32 (2.5x fewer bytes to the card). Off by
    default: it quantizes images to 1/255 steps, exact for 8-bit sources
    only. The same wire as ``data/packed.py:NativePackedIterator``."""

    def __init__(self, ds: DepthDataset, batch_size: int, seed: int = 0, shuffle: bool = True,
                 prefetch: int = 2, loop: bool = True, shard_index: int = 0,
                 num_shards: int = 1, start_step: int = 0, uint8_wire: bool = False):
        if len(ds) < batch_size * num_shards:
            raise ValueError(f"dataset of {len(ds)} samples cannot fill batch "
                             f"{batch_size} x {num_shards} hosts")
        self.ds, self.batch_size, self.seed = ds, batch_size, seed
        self.shuffle, self.loop = shuffle, loop
        self.shard_index, self.num_shards = shard_index, num_shards
        self.start_step, self.uint8_wire = start_step, uint8_wire
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        self._stopped = False
        self._done = False
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _index_stream(self):
        epoch, skip = 0, self.start_step
        while True:
            idx = np.arange(len(self.ds))
            if self.shuffle:
                np.random.default_rng((self.seed, epoch)).shuffle(idx)
            if self.num_shards > 1:
                # the common per-shard length: a plain stride would give
                # shards different batch counts when len(ds) % num_shards
                common = len(idx) // self.num_shards
                idx = idx[self.shard_index::self.num_shards][:common]
            n_batches = len(idx) // self.batch_size
            if skip >= n_batches:
                skip -= n_batches
            else:
                for b in range(skip, n_batches):
                    yield idx[b * self.batch_size:(b + 1) * self.batch_size]
                skip = 0
            if not self.loop:
                return
            epoch += 1

    def _put(self, item) -> bool:
        """Bounded put that keeps observing the stop flag."""
        while not self._stopped:
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _to_wire(self, batch):
        if self.uint8_wire:
            batch["image"] = np.clip(batch["image"] * 255.0 + 0.5, 0, 255).astype(np.uint8)
            if "mask" in batch:
                batch["mask"] = (batch["mask"] > 0).astype(np.uint8)
        return batch

    def _producer(self):
        try:
            for batch_idx in self._index_stream():
                if self._stopped:
                    return
                if not self._put(self._to_wire(_stack([self.ds[int(i)] for i in batch_idx]))):
                    return
            self._put(None)  # end of a loop=False stream
        except Exception as e:  # handed to the consumer, raised by __next__
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._done:
            raise StopIteration  # stay exhausted: the sentinel was consumed
        item = self._q.get()
        if item is None:
            self._done = True
            raise StopIteration
        if isinstance(item, Exception):
            self._done = True
            raise item
        return item

    def close(self):
        self._stopped = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


def pregenerate_val_rankings(ds: DepthDataset, *, sampler_name: str, rankings_per_image: int,
                             ranking_size: int, threshold: float = 0.03, seed: int = 0,
                             chunk: int = 16, device="cpu") -> np.ndarray:
    """(N, RPI, K, 2) fixed validation rankings, sampled on ``device`` in
    chunks. The reference validates with the thresholded sampler whatever
    the training strategy (hourglass_provider.py:22); callers pass
    sampler_name="thresholded"."""
    out = []
    for start in range(0, len(ds), chunk):
        items = [ds[i] for i in range(start, min(start + chunk, len(ds)))]
        gts = torch.from_numpy(np.stack([s["gt"] for s in items])).to(device)
        masks = torch.from_numpy(np.stack([s["mask"] for s in items])).to(device)
        r = sample_rankings_batch(
            generator(seed, "val", start, device), gts, masks,
            sampler_name=sampler_name, rankings_per_image=rankings_per_image,
            ranking_size=ranking_size, threshold=threshold)
        out.append(r.cpu().numpy())
    return np.concatenate(out, axis=0)


def val_batches(ds: DepthDataset, rankings: np.ndarray,
                batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
    """Fixed-order validation batches carrying pre-generated rankings."""
    for b in range(len(ds) // batch_size):
        items = [ds[i] for i in range(b * batch_size, (b + 1) * batch_size)]
        yield {"image": np.stack([s["image"] for s in items]),
               "rankings": rankings[b * batch_size:(b + 1) * batch_size]}

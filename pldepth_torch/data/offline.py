"""Offline dump of sampled (image, rankings) training data
(``pldepth_tpu/data/offline.py``).

Rebuild of the reference offline dump (pldepth/active_learning/
offline_data.py:16-127: a subclassed provider and a script writing jpg + npy
per sample). One function samples rankings for a whole dataset on the device
in chunks of ``chunk`` images and writes either per-sample files (jpg + npy,
the reference layout) or one packed archive for fast reload, with the JAX
package's file names and ``meta.json`` keys. Chunk ``start``'s lists come
from a generator keyed by (seed, start): the same distribution as the JAX
package's ``fold_in(key(seed), start)`` draws, not the same bits.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np
import torch

from pldepth_torch.core.device import DeviceLike, resolve_device
from pldepth_torch.core.rng import generator
from pldepth_torch.data.datasets import DepthDataset
from pldepth_torch.sampling import sample_rankings_batch

log = logging.getLogger(__name__)


def _u8(image: np.ndarray) -> np.ndarray:
    return (np.clip(image, 0, 1) * 255).astype(np.uint8)


def dump_offline_data(
    ds: DepthDataset,
    out_dir: str,
    *,
    sampler_name: str = "info_score",
    rankings_per_image: int = 100,
    ranking_size: int = 5,
    threshold: float = 0.03,
    seed: int = 0,
    chunk: int = 16,
    image_format: str = "jpg",  # "jpg" per-sample files | "npz" single archive
    device: DeviceLike = None,
) -> str:
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    all_rankings = []
    for start in range(0, len(ds), chunk):
        items = [ds[i] for i in range(start, min(start + chunk, len(ds)))]
        gts = torch.from_numpy(np.stack([s["gt"] for s in items])).to(dev)
        masks = torch.from_numpy(np.stack([s["mask"] for s in items])).to(dev)
        r = sample_rankings_batch(
            generator(seed, "dump", start, dev), gts, masks,
            sampler_name=sampler_name,
            rankings_per_image=rankings_per_image,
            ranking_size=ranking_size,
            threshold=threshold,
        ).cpu().numpy()
        if image_format == "jpg":
            from PIL import Image

            for j, s in enumerate(items):
                idx = start + j
                Image.fromarray(_u8(s["image"])).save(
                    os.path.join(out_dir, f"{idx:06d}.jpg"), quality=95)
                np.save(os.path.join(out_dir, f"{idx:06d}_rankings.npy"), r[j])
        all_rankings.append(r)

    rankings = np.concatenate(all_rankings, axis=0)
    if image_format == "npz":
        images = np.stack([_u8(ds[i]["image"]) for i in range(len(ds))])
        np.savez_compressed(
            os.path.join(out_dir, "offline_data.npz"),
            images=images, rankings=rankings,
        )
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(
            {
                "n": len(ds), "sampler": sampler_name,
                "rankings_per_image": rankings_per_image,
                "ranking_size": ranking_size, "threshold": threshold, "seed": seed,
            },
            f, indent=2,
        )
    log.info("dumped %d samples to %s", len(ds), out_dir)
    return out_dir


def load_offline_rankings(out_dir: str) -> np.ndarray:
    """Load the ranking arrays written by :func:`dump_offline_data`."""
    npz = os.path.join(out_dir, "offline_data.npz")
    if os.path.exists(npz):
        return np.load(npz)["rankings"]
    files = sorted(
        f for f in os.listdir(out_dir) if f.endswith("_rankings.npy")
    )
    return np.stack([np.load(os.path.join(out_dir, f)) for f in files])

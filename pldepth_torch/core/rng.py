"""Seeded ``torch.Generator`` streams, keyed by stable string tags.

The JAX package folds string tags into one root key
(``pldepth_tpu/core/rng.py``). torch generators cannot be folded, so a
stream is a fresh generator whose seed is derived from (root seed, tag,
index) by a hash that is stable across processes. The bits differ from
JAX's for the same seed; tests that compare the packages make their inputs
with numpy and hand them to both.
"""

from __future__ import annotations

import hashlib

import torch


def derive_seed(seed: int, tag: str, index: int = 0) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{tag}:{int(index)}".encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, tag: str, index: int = 0, device="cpu") -> torch.Generator:
    """A generator on ``device`` seeded from (seed, tag, index). Weights are
    made on the CPU so their values do not depend on the device; the train
    step's draws (flip, sampling, drop-path) use generators on the card,
    one per (seed, tag, step), so a resumed run draws what the
    uninterrupted one drew."""
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, tag, index))
    return g

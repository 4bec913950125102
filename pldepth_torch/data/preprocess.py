"""Batch preprocessing on the device (``pldepth_tpu/data/preprocess.py``):
normalisation of [0,1] NHWC images for a backbone, and the per-sample
horizontal flip augmentation of the train step.
"""

from __future__ import annotations

import torch

from pldepth_torch.core.mesh import batch_rand

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CAFFE_MEAN_BGR = (103.939, 116.779, 123.68)


def normalize_images(images: torch.Tensor, mode: str) -> torch.Tensor:
    """Normalize a [0,1]-ranged NHWC image batch for the given backbone."""
    images = images.to(torch.float32)
    if mode == "effnet":
        mean = images.new_tensor(IMAGENET_MEAN)
        std = images.new_tensor(IMAGENET_STD)
        return (images - mean) / std
    if mode == "caffe":
        bgr = images.flip(-1) * 255.0
        return bgr - images.new_tensor(CAFFE_MEAN_BGR)
    if mode == "none":
        return images
    raise ValueError(f"unknown normalization mode {mode!r}")


def flip_batch(flip: torch.Tensor, images: torch.Tensor, gts: torch.Tensor,
               masks: torch.Tensor):
    """Mirror the width axis of the samples whose flag is set: images
    (B, H, W, C), gts and masks (B, H, W)."""

    def sel(x):
        f = flip.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(f, x.flip(2), x)

    return sel(images), sel(gts), sel(masks)


def random_flip_batch(gen: torch.Generator, images: torch.Tensor, gts: torch.Tensor,
                      masks: torch.Tensor):
    """Per-sample horizontal flip (reference augment_fn,
    hourglass_provider.py:34-51): each sample flips with probability 0.5,
    drawn from ``gen`` (the ``jax.random.bernoulli`` draw; other bits)."""
    flip = batch_rand(gen, (images.shape[0],), gen.device) < 0.5
    return flip_batch(flip, images, gts, masks)

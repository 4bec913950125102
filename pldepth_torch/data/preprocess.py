"""Batch normalisation of [0,1] NHWC images for a backbone
(``pldepth_tpu/data/preprocess.py:normalize_images``). The flip
augmentation comes with the training slice.
"""

from __future__ import annotations

import torch

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

"""Device resolution for the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU. A
missing card is an error, never a silent move to the CPU: a number taken on
the CPU must not pass for one taken on the GPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU"
        )
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """'bfloat16' / 'float32' / ... -> torch dtype (cfg.compute_dtype)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt

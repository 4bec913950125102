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


def resolve_impl(impl: str, device: DeviceLike) -> str:
    """Which implementation of a kernel op runs on ``device`` (the twin of
    ``pldepth_tpu/ops/listmle.py:_resolve_impl``; the config values keep
    their JAX names). ``"auto"``: the hand-written kernel on CUDA, the plain
    PyTorch version on the CPU. ``"pallas"``: the kernel, which has no CPU
    mode, so it raises there. ``"xla"``: the plain version anywhere."""
    dev = torch.device(device if device is not None else "cuda")
    if impl == "auto":
        return "pallas" if dev.type == "cuda" else "xla"
    if impl == "pallas":
        if dev.type != "cuda":
            raise RuntimeError(
                f"impl='pallas' runs the CUDA kernel and has no {dev.type} mode; "
                "use impl='auto' or 'xla' off the card")
        return impl
    if impl == "xla":
        return impl
    raise ValueError(f"unknown impl {impl!r} (have 'auto', 'pallas', 'xla')")


def torch_dtype(name: str) -> torch.dtype:
    """'bfloat16' / 'float32' / ... -> torch dtype (cfg.compute_dtype)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt

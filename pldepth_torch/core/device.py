"""Device resolution for the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU. A
missing card is an error, never a silent move to the CPU: a number taken on
the CPU must not pass for one taken on the GPU.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple, Union

import torch
from torch._subclasses.fake_tensor import is_fake

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


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` as float32, or as it is when it is float64. The port's float32
    sites (batch-norm statistics, the squeeze-excite mean, the depth map,
    the loss, the optimizer's flat state) keep a float64 network in
    float64, so two ways of computing one step can be held to each other
    far below float32's rounding."""
    return x if x.dtype == torch.float64 else x.to(torch.float32)


class Constants:
    """Fixed values as a tensor on a device, made once per (device, dtype)
    and kept: a step that reads them makes no host-to-device copy, which
    would wait for the stream and cannot be captured in a CUDA graph. They
    are made outside inference mode, so a step with autograd may save them
    after a prediction made them. A tensor that ``torch.export`` traces (a
    fake tensor) gets a fresh one, made as before and not kept."""

    def __init__(self, values):
        self.values = values
        self._made: Dict[Tuple[torch.device, torch.dtype], torch.Tensor] = {}

    def like(self, t: torch.Tensor) -> torch.Tensor:
        """The values in ``t``'s dtype on ``t``'s device."""
        if is_fake(t):
            return torch.as_tensor(self.values, dtype=t.dtype, device=t.device)
        key = (t.device, t.dtype)
        made = self._made.get(key)
        if made is None:
            with torch.inference_mode(False):
                made = torch.as_tensor(self.values, dtype=t.dtype, device=t.device)
            self._made[key] = made
        return made


def local_cuda_index() -> int:
    """The card of this process under a launcher: ``LOCAL_RANK`` modulo
    the cards the host has (0 without a launcher). Ranks beyond the card
    count share cards (core/mesh.py then takes gloo)."""
    return int(os.environ.get("LOCAL_RANK", 0)) % max(1, torch.cuda.device_count())


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

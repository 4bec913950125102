"""Sorted ListMLE NLL (K1): hand-written Hopper kernels, forward and backward.

Replaces the TPU kernels ``pldepth_tpu/ops/listmle_pallas.py:_fwd_kernel``
and ``_bwd_kernel`` (the ``listmle_sorted`` custom VJP). The CUDA source is
``pldepth_torch/csrc/listmle.cu``: one thread per list walks its row of the
row-major (N, K) f32 scores, runs the exact suffix logaddexp recurrence in
the forward (saving ``lse``) and the prefix recurrence of the closed-form
gradient in the backward. It is bound by bytes (141 KB forward, 205 KB
backward at N=3200, K=5), so a launch costs more than the work.

Each wrapper takes the plain PyTorch version (``torch.logcumsumexp`` on the
flipped list, the twin of ``_listmle_sorted_xla``) for a CPU tensor only; a
CUDA tensor launches the kernel or raises. ``listmle_fwd.launches`` and
``listmle_bwd.launches`` count kernel launches (chip_smoke.py reads them).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch


def listmle_fwd_plain(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, K) f32 label-sorted scores -> (nll (N,), lse (N, K))."""
    lse = torch.logcumsumexp(s.flip(-1), dim=-1).flip(-1)
    return (lse - s).sum(-1), lse


def listmle_bwd_plain(s: torch.Tensor, lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """ds_j = g * (exp(s_j + P_j) - 1), P_j = log sum_{i<=j} exp(-lse_i)."""
    p = torch.logcumsumexp(-lse, dim=-1)
    return (torch.exp(s + p) - 1.0) * g[:, None]


def _check(name: str, *tensors: torch.Tensor) -> torch.device:
    s = tensors[0]
    if s.dim() != 2 or s.shape[1] < 1:
        raise ValueError(f"{name}: scores must be (N, K) with K >= 1, got {tuple(s.shape)}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 tensors only, got {t.dtype}")
        if t.device != s.device:
            raise ValueError(f"{name}: tensors on {t.device} and {s.device}")
    if s.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: unsupported device {s.device}")
    return s.device


def _launch(symbol: str, device: torch.device, *args) -> None:
    from pldepth_torch.ops._build import load_library

    fn = getattr(load_library("listmle"), symbol)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    if not t.is_contiguous():
        raise ValueError("listmle kernels take contiguous tensors")
    return ctypes.c_void_p(t.data_ptr())


def listmle_fwd(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward of K1: (N, K) f32 label-sorted scores -> (nll (N,), lse (N, K))."""
    device = _check("listmle_fwd", s)
    if device.type == "cpu":
        return listmle_fwd_plain(s)
    n, k = s.shape
    nll = torch.empty(n, dtype=torch.float32, device=device)
    lse = torch.empty((n, k), dtype=torch.float32, device=device)
    if n == 0:
        return nll, lse
    _launch("listmle_fwd", device, _ptr(s), _ptr(nll), _ptr(lse), n, k)
    listmle_fwd.launches += 1
    return nll, lse


def listmle_bwd(s: torch.Tensor, lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Backward of K1: (N, K) scores and lse, (N,) cotangent -> (N, K) ds."""
    device = _check("listmle_bwd", s, lse, g)
    if lse.shape != s.shape or g.shape != s.shape[:1]:
        raise ValueError(f"listmle_bwd: shapes s {tuple(s.shape)}, lse "
                         f"{tuple(lse.shape)}, g {tuple(g.shape)}")
    if device.type == "cpu":
        return listmle_bwd_plain(s, lse, g)
    n, k = s.shape
    ds = torch.empty((n, k), dtype=torch.float32, device=device)
    if n == 0:
        return ds
    _launch("listmle_bwd", device, _ptr(s), _ptr(lse), _ptr(g), _ptr(ds), n, k)
    listmle_bwd.launches += 1
    return ds


# launches of the CUDA kernels (not of the plain versions)
listmle_fwd.launches = 0
listmle_bwd.launches = 0


class ListMLESorted(torch.autograd.Function):
    """Per-list NLL of label-sorted (N, K) f32 scores -> (N,): K1 forward,
    with K1 backward as its gradient (the ``listmle_sorted`` custom VJP)."""

    @staticmethod
    def forward(ctx, s: torch.Tensor) -> torch.Tensor:
        s = s.contiguous()
        nll, lse = listmle_fwd(s)
        ctx.save_for_backward(s, lse)
        return nll

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        s, lse = ctx.saved_tensors
        return listmle_bwd(s, lse, g.to(torch.float32).contiguous())


def listmle_sorted(s: torch.Tensor) -> torch.Tensor:
    """K1 with autograd: (N, K) label-sorted scores -> (N,) NLL."""
    return ListMLESorted.apply(s.to(torch.float32))

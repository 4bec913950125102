"""K1: the ListMLE ranking loss on hand-written Hopper kernels, forward and
backward, and the sorted NLL that the TPU kernels compute.

Replaces the TPU kernels ``pldepth_tpu/ops/listmle_pallas.py:_fwd_kernel``
and ``_bwd_kernel`` (the ``listmle_sorted`` custom VJP). The CUDA source is
``pldepth_torch/csrc/listmle.cu``:

* ``ranking_loss_fwd`` / ``ranking_loss_bwd`` (``RankingLoss``) compute the
  whole loss of ``pl_ranking_loss``: the gather of the (B, P) depth map at
  the ranked pixels (the index rule of ``jnp.take_along_axis``), the stable
  label sort, the exact suffix logaddexp NLL and the mean over the lists in
  one launch; the closed-form gradient, atomically added into a
  zero-filled map, in one more;
* ``listmle_fwd`` / ``listmle_bwd`` (``ListMLESorted``) compute the NLL of
  label-sorted (N, K) lists, the TPU kernels' own function.

Both are bound by the launch, then by bytes. A thread per list for the
configs' K (3, 5, 10), a warp per list otherwise (``listmle.cu``).

Each wrapper takes its plain PyTorch version for a CPU tensor only; a CUDA
tensor launches the kernel or raises. ``<wrapper>.launches`` counts kernel
launches (chip_smoke.py reads them).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pldepth_torch.core.device import wide

K_MAX = 2048  # longest list the CUDA kernels take (listmle.cu kMaxK)
LAYOUTS = {None: 0, "thread": 1, "warp": 2}  # None: listmle.cu picks


# --- plain versions --------------------------------------------------------

def listmle_fwd_plain(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, K) f32 label-sorted scores -> (nll (N,), lse (N, K))."""
    lse = torch.logcumsumexp(s.flip(-1), dim=-1).flip(-1)
    return (lse - s).sum(-1), lse


def listmle_bwd_plain(s: torch.Tensor, lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """ds_j = g * (exp(s_j + P_j) - 1), P_j = log sum_{i<=j} exp(-lse_i)."""
    p = torch.logcumsumexp(-lse, dim=-1)
    return (torch.exp(s + p) - 1.0) * g[:, None]


def sort_by_labels_desc(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Scores in descending label order, ties by position, NaN labels last."""
    order = torch.argsort(-labels, dim=-1, stable=True)
    return torch.take_along_dim(scores, order, dim=-1)


def ranking_index(coord: torch.Tensor) -> torch.Tensor:
    """Flat pixel indices from the f32 ``rankings[..., 0]``: truncated
    toward zero as ``.astype(jnp.int32)``, a NaN reading 0 as XLA's
    convert gives."""
    return torch.where(torch.isnan(coord), 0.0, coord).to(torch.int64)


def flat_pixels(idx: torch.Tensor, p: int) -> torch.Tensor:
    """Integer pixel indices of a map of ``p`` pixels by the rule of
    ``jnp.take_along_axis``: a negative index wraps once; -1 where one is
    still outside [0, p) (it reads NaN and gets no gradient)."""
    idx = torch.where(idx < 0, idx + p, idx)
    return torch.where((idx >= 0) & (idx < p), idx, -1)


def _gather_or_nan(flat: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(B, P) ``flat`` at (B, M) ``ids`` in [0, P) or -1 (NaN there)."""
    got = torch.gather(flat, 1, ids.clamp_min(0))
    return torch.where(ids >= 0, got, torch.nan)


def gather_ranked_scores(pred_maps: torch.Tensor, point_idx: torch.Tensor) -> torch.Tensor:
    """Predicted depths at flat ``x * W + y`` pixel indices.

    pred_maps: (B, H, W) or (B, H, W, 1); point_idx: (B, RPI, K) integer.
    Returns (B * RPI, K); the backward is autograd's scatter-add."""
    b = pred_maps.shape[0]
    flat = pred_maps.reshape(b, -1)
    ids = flat_pixels(point_idx.reshape(b, -1).long(), flat.shape[1])
    return _gather_or_nan(flat, ids).reshape(-1, point_idx.shape[-1])


def ranking_nll_plain(pred: torch.Tensor, rankings: torch.Tensor) -> torch.Tensor:
    """Per-list NLL of (B, ...) f32 maps against (B, RPI, K, 2) rankings,
    plain PyTorch with autograd: (B * RPI,)."""
    k = rankings.shape[-2]
    scores = gather_ranked_scores(wide(pred), ranking_index(rankings[..., 0]))
    return listmle_fwd_plain(sort_by_labels_desc(scores, rankings[..., 1].reshape(-1, k)))[0]


def ranking_loss_plain(pred: torch.Tensor, rankings: torch.Tensor) -> torch.Tensor:
    """Mean ListMLE loss, plain PyTorch with autograd (the JAX loss's chain)."""
    return ranking_nll_plain(pred, rankings).mean()


def _sorted_pixels(pred: torch.Tensor, sidx: torch.Tensor) -> torch.Tensor:
    """(N, K) scores of the (B, P) map at saved flat indices, NaN at -1."""
    return _gather_or_nan(pred, sidx.reshape(pred.shape[0], -1).long()).reshape(sidx.shape)


def ranking_loss_fwd_plain(pred: torch.Tensor, rankings: torch.Tensor):
    """(B, P) map, (B, RPI, K, 2) rankings -> (loss (), nll (N,), lse (N, K),
    sorted flat indices (N, K) int32, -1 where the pixel was dropped)."""
    k = rankings.shape[-2]
    idx = flat_pixels(ranking_index(rankings[..., 0]), pred.shape[1]).reshape(-1, k)
    sidx = sort_by_labels_desc(idx, rankings[..., 1].reshape(-1, k))
    nll, lse = listmle_fwd_plain(_sorted_pixels(pred, sidx))
    return nll.mean(), nll, lse, sidx.to(torch.int32)


def ranking_loss_bwd_plain(pred: torch.Tensor, lse: torch.Tensor, sidx: torch.Tensor,
                           g: torch.Tensor) -> torch.Tensor:
    """Gradient map (B, P) of the mean loss for the cotangent g ()."""
    n = sidx.shape[0]
    ds = listmle_bwd_plain(_sorted_pixels(pred, sidx), lse, (g / n).expand(n))
    ids = sidx.reshape(pred.shape[0], -1).long()
    keep = ids >= 0
    return torch.zeros_like(pred).scatter_add_(
        1, ids.clamp_min(0), torch.where(keep, ds.reshape(ids.shape), 0.0))


# --- the CUDA kernels --------------------------------------------------------

_fns = {}
_workspaces = {}  # device index -> (ticket counter, per-block partial sums)
_outgrown = []  # partial sums a larger workspace replaced: a CUDA graph may still write them


def _launch(symbol: str, device: torch.device, *args) -> None:
    """Call a listmle.cu entry point on the current stream of ``device``;
    the ctypes symbol is resolved once a process."""
    fn = _fns.get(symbol)
    if fn is None:
        from pldepth_torch.ops._build import load_library

        fn = _fns[symbol] = getattr(load_library("listmle"), symbol)
    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")


def _workspace(device: torch.device, n: int):
    """The ticket counter (zero between launches) and room for one partial
    sum a block (at most one block a list), kept per device and never
    freed (a captured train step launches K1 on them)."""
    key = device.index if device.index is not None else torch.cuda.current_device()
    ws = _workspaces.get(key)
    if ws is None or ws[1].numel() < n:
        ticket = ws[0] if ws else torch.zeros(1, dtype=torch.int32, device=device)
        if ws:
            _outgrown.append(ws[1])
        ws = _workspaces[key] = (ticket, torch.empty(max(n, 4096), device=device))
    return ws


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(name: str, *tensors: torch.Tensor) -> torch.device:
    s = tensors[0]
    if s.dim() != 2 or s.shape[1] < 1:
        raise ValueError(f"{name}: scores must be (N, K) with K >= 1, got {tuple(s.shape)}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 tensors only, got {t.dtype}")
        if t.device != s.device:
            raise ValueError(f"{name}: tensors on {t.device} and {s.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: contiguous tensors only")
    if s.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: unsupported device {s.device}")
    return s.device


def _check_k(name: str, k: int) -> None:
    if k > K_MAX:
        raise ValueError(f"{name}: lists of at most {K_MAX} on the card, got {k}")


def listmle_fwd(s: torch.Tensor, layout: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted K1 forward: (N, K) f32 label-sorted scores -> (nll (N,),
    lse (N, K))."""
    device = _check("listmle_fwd", s)
    if device.type == "cpu":
        return listmle_fwd_plain(s)
    n, k = s.shape
    _check_k("listmle_fwd", k)
    nll = torch.empty(n, dtype=torch.float32, device=device)
    lse = torch.empty((n, k), dtype=torch.float32, device=device)
    if n == 0:
        return nll, lse
    _launch("listmle_fwd", device, s.data_ptr(), nll.data_ptr(), lse.data_ptr(), n, k,
            LAYOUTS[layout])
    listmle_fwd.launches += 1
    return nll, lse


def listmle_bwd(s: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                layout: Optional[str] = None) -> torch.Tensor:
    """Sorted K1 backward: (N, K) scores and lse, (N,) cotangent -> (N, K) ds."""
    device = _check("listmle_bwd", s, lse, g)
    if lse.shape != s.shape or g.shape != s.shape[:1]:
        raise ValueError(f"listmle_bwd: shapes s {tuple(s.shape)}, lse "
                         f"{tuple(lse.shape)}, g {tuple(g.shape)}")
    if device.type == "cpu":
        return listmle_bwd_plain(s, lse, g)
    n, k = s.shape
    _check_k("listmle_bwd", k)
    ds = torch.empty((n, k), dtype=torch.float32, device=device)
    if n == 0:
        return ds
    _launch("listmle_bwd", device, s.data_ptr(), lse.data_ptr(), g.data_ptr(), ds.data_ptr(),
            n, k, LAYOUTS[layout])
    listmle_bwd.launches += 1
    return ds


def ranking_loss_fwd(pred: torch.Tensor, rankings: torch.Tensor, residuals: bool = True,
                     layout: Optional[str] = None):
    """Fused K1 forward: (B, P) f32 map and (B, RPI, K, 2) f32 rankings ->
    (loss (), nll (N,), lse (N, K), sorted flat indices (N, K) int32), the
    last two None without ``residuals``. N = B * RPI."""
    if rankings.dim() != 4 or rankings.shape[-1] != 2 or rankings.shape[0] != pred.shape[0]:
        raise ValueError(f"ranking_loss_fwd: rankings {tuple(rankings.shape)} for a map "
                         f"{tuple(pred.shape)}; want (B, RPI, K, 2)")
    b, rpi, k, _ = rankings.shape
    device = _check("ranking_loss_fwd", pred, rankings)
    if device.type == "cpu":
        loss, nll, lse, sidx = ranking_loss_fwd_plain(pred, rankings)
        return (loss, nll, lse, sidx) if residuals else (loss, nll, None, None)
    _check_k("ranking_loss_fwd", k)
    if rankings.data_ptr() % 8:  # the kernel reads (index, label) as one 8-byte load
        rankings = rankings.clone()
    n = b * rpi
    nll = torch.empty(n, dtype=torch.float32, device=device)
    loss = torch.full((), torch.nan, device=device) if n == 0 else torch.empty(
        (), dtype=torch.float32, device=device)
    lse = torch.empty((n, k), dtype=torch.float32, device=device) if residuals else None
    sidx = torch.empty((n, k), dtype=torch.int32, device=device) if residuals else None
    if n == 0:
        return loss, nll, lse, sidx
    ticket, partial = _workspace(device, n)
    _launch("ranking_loss_fwd", device, pred.data_ptr(), rankings.data_ptr(), nll.data_ptr(),
            _ptr(lse), _ptr(sidx), partial.data_ptr(), ticket.data_ptr(), loss.data_ptr(),
            n, k, rpi, pred.shape[1], LAYOUTS[layout])
    ranking_loss_fwd.launches += 1
    return loss, nll, lse, sidx


def ranking_loss_bwd(pred: torch.Tensor, lse: torch.Tensor, sidx: torch.Tensor,
                     g: torch.Tensor, layout: Optional[str] = None) -> torch.Tensor:
    """Fused K1 backward: (B, P) map, the forward's lse and sorted indices,
    the cotangent g () of the mean loss -> the (B, P) gradient map."""
    device = _check("ranking_loss_bwd", pred, lse, g)
    n, k = lse.shape
    b = pred.shape[0]
    if (sidx.shape != lse.shape or sidx.dtype != torch.int32 or sidx.device != device
            or not sidx.is_contiguous() or g.numel() != 1 or n != b * (n // max(b, 1))):
        raise ValueError(f"ranking_loss_bwd: lse {tuple(lse.shape)}, sidx "
                         f"{tuple(sidx.shape)} {sidx.dtype} on {sidx.device}, g "
                         f"{tuple(g.shape)} for a map {tuple(pred.shape)}")
    if device.type == "cpu":
        return ranking_loss_bwd_plain(pred, lse, sidx, g.reshape(()))
    _check_k("ranking_loss_bwd", k)
    grad = torch.zeros_like(pred)
    if n == 0:
        return grad
    _launch("ranking_loss_bwd", device, pred.data_ptr(), lse.data_ptr(), sidx.data_ptr(),
            g.data_ptr(), grad.data_ptr(), n, k, n // b, pred.shape[1],
            LAYOUTS[layout])
    ranking_loss_bwd.launches += 1
    return grad


def launch_floor(device: torch.device) -> None:
    """One launch of an empty kernel of the same library (the launch floor
    chip_smoke.py times the fused kernels against)."""
    _launch("listmle_empty", device)


# launches of the CUDA kernels (not of the plain versions)
listmle_fwd.launches = 0
listmle_bwd.launches = 0
ranking_loss_fwd.launches = 0
ranking_loss_bwd.launches = 0


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


class RankingLoss(torch.autograd.Function):
    """Mean ListMLE loss of a (B, ...) f32 map against (B, RPI, K, 2) f32
    rankings -> (): the fused K1 forward, with the fused K1 backward (the
    gradient map) as its gradient. Saves lse and the sorted indices only
    where ``need_grad``."""

    @staticmethod
    def forward(ctx, pred: torch.Tensor, rankings: torch.Tensor, need_grad: bool):
        flat = pred.reshape(pred.shape[0], -1).contiguous()
        loss, _, lse, sidx = ranking_loss_fwd(flat, rankings.contiguous(), residuals=need_grad)
        ctx.shape = pred.shape
        if need_grad:
            ctx.save_for_backward(flat, lse, sidx)
        return loss

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        flat, lse, sidx = ctx.saved_tensors
        grad = ranking_loss_bwd(flat, lse, sidx, g.to(torch.float32).contiguous())
        return grad.view(ctx.shape), None, None


def ranking_loss(pred: torch.Tensor, rankings: torch.Tensor) -> torch.Tensor:
    """The fused K1 loss with autograd: mean NLL of (B, ...) maps against
    (B, RPI, K, 2) rankings."""
    pred = pred.to(torch.float32)
    need_grad = torch.is_grad_enabled() and pred.requires_grad
    return RankingLoss.apply(pred, rankings.to(torch.float32), need_grad)

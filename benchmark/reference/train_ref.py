"""Plain PyTorch training steps: the reference that a training cell's first
steps are held against.

It works out again, from the benchmark's own inputs (the depth set, the
weights and the seed), everything that one train step of the configured
algorithm derives: the feed's batch of each step, the uint8 / uint16
encoding of a resident store and its draws, the flip augmentation, the
ranking sampler, the train-mode forward (reference/nets.py), the
Plackett-Luce ListMLE loss, its gradient (autograd), SGDR's learning rate
and the AMSGrad update. The random draws follow the configuration's
documented protocol: one ``torch.Generator`` on the card for each (seed,
tag, step), seeded from the first 8 bytes of sha256(``"seed:tag:step"``),
and each drawn at the global batch's shape. Imports nothing of the program.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import nets

EQUALITY_PENALTY = -1000.0
OVERSAMPLE = {"thresholded": 1.5, "info_score": 5.0}
SAMPLER_OF_TYPE = {0: "thresholded", 1: "info_score"}


def generator(seed: int, tag: str, index: int, device) -> torch.Generator:
    digest = hashlib.sha256(f"{int(seed)}:{tag}:{int(index)}".encode("utf-8")).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") & ((1 << 63) - 1))
    return g


# ------------------------------------------------------------------ feeds
def host_batch_rows(seed: int, n: int, batch: int, step: int, shards: int = 1,
                    shard: int = 0) -> np.ndarray:
    """Sample indices of host batch ``step``: epoch e's permutation is
    ``default_rng((seed, e)).shuffle(arange(n))``, a shard takes the stride
    ``shard::shards`` of it cut to ``n // shards``, batches run in order."""
    per_shard = n // shards
    per_epoch = per_shard // batch
    epoch, b = divmod(step, per_epoch)
    idx = np.arange(n)
    np.random.default_rng((seed, epoch)).shuffle(idx)
    if shards > 1:
        idx = idx[shard::shards][:per_shard]
    return idx[b * batch:(b + 1) * batch]


def resident_encode(images: np.ndarray, gts: np.ndarray, masks: np.ndarray):
    """A resident store's encoding: uint8 images (round half to even), gt as
    uint16 multiples of ``max(gt) / 65535``, uint8 masks. Returns (images
    u8, gt q as float32 counts, masks u8, gt scale as float32)."""
    img = np.clip(np.round(images * 255.0), 0, 255).astype(np.uint8)
    gt_scale = max(float(gts.max()), 1e-6) / 65535.0
    q = np.clip(np.round(gts / gt_scale), 0, 65535).astype(np.uint16)
    return img, q.astype(np.float32), (masks > 0).astype(np.uint8), np.float32(gt_scale)


def resident_rows(seed: int, n: int, batch: int, step: int, device, data_index: int = 0):
    tag = "train/resident" + (f"/{data_index}" if data_index else "")
    return torch.randint(0, n, (batch,), generator=generator(seed, tag, step, device),
                         device=device)


# ---------------------------------------------------------------- sampling
def _global_rand(g, shape, index: int, count: int, device):
    """``torch.rand`` at the global batch's shape, this data index's rows."""
    full = torch.rand((shape[0] * count, *shape[1:]), generator=g, device=device)
    return full.narrow(0, index * shape[0], shape[0]) if count > 1 else full


def flip(seed, step, images, gts, masks, index: int = 0, count: int = 1):
    g = generator(seed, "train/flip", step, images.device)
    f = _global_rand(g, (images.shape[0],), index, count, images.device) < 0.5

    def sel(x):
        m = f.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(m, x.flip(2), x)

    return sel(images), sel(gts), sel(masks)


def _relation_equal(d1, d2, tau: float):
    ratio = (d1 + 1e-10) / (d2 + 1e-10)
    hi = 1.0 + tau
    return (ratio < hi) & (ratio > 1.0 / hi)


def sample_rankings(seed, step, gts, masks, sampler: str, rpi: int, k: int,
                    threshold: float = 0.03, index: int = 0, count: int = 1) -> torch.Tensor:
    """(B, RPI, K, 2) rankings [flat index, depth], each list by depth
    descending: ``n_cand = rpi * oversample`` candidate lists of K pixels
    drawn uniformly from the mask ("the g-th valid pixel", ``g = u *
    n_valid``), each list sorted, scored, and the best RPI kept."""
    b = gts.shape[0]
    g = generator(seed, "train/sample", step, gts.device)
    n_cand = max(int(rpi * OVERSAMPLE[sampler]), rpi)
    m = masks.reshape(b, -1) > 0
    m = torch.where(m.any(-1, keepdim=True), m, torch.ones_like(m))
    csum = torch.cumsum(m.to(torch.int64), dim=-1)
    n_valid = csum[:, -1:]
    u = _global_rand(g, (b, n_cand * k), index, count, gts.device)
    gi = torch.minimum((u * n_valid.to(torch.float32)).to(torch.int64), n_valid - 1)
    idx = torch.searchsorted(csum, gi + 1).reshape(b, n_cand, k)
    flat = gts.reshape(b, -1)
    depth = torch.gather(flat, 1, idx.reshape(b, -1)).reshape(b, n_cand, k)
    order = torch.argsort(-depth, dim=-1, stable=True)
    depth = torch.take_along_dim(depth, order, dim=-1)
    idxf = torch.take_along_dim(idx.to(torch.float32), order, dim=-1)
    diffs = (depth[..., :-1] - depth[..., 1:]).abs()
    penalty = EQUALITY_PENALTY * _relation_equal(depth[..., :-1], depth[..., 1:],
                                                 threshold).float().sum(-1)
    if sampler == "thresholded":
        score = diffs.sum(-1) + penalty
    else:  # info_score: -chi2 against linspace(min + 1e-3, max, K + 1)[1:]
        lo = flat.amin(-1)[:, None, None] + 0.001
        hi = flat.amax(-1)[:, None, None]
        steps = torch.arange(1, k + 1, dtype=torch.float32, device=gts.device)
        expected = lo + (hi - lo) * steps / k
        score = -(torch.square(depth - expected) / expected).sum(-1) + penalty
    top = torch.argsort(-score, dim=-1, stable=True)[..., :rpi, None]
    return torch.stack([torch.take_along_dim(idxf, top, dim=1),
                        torch.take_along_dim(depth, top, dim=1)], dim=-1)


# ------------------------------------------------------------------- loss
def listmle_loss(pred: torch.Tensor, rankings: torch.Tensor) -> torch.Tensor:
    """Mean over lists of ``sum_i [log sum_{j >= i} exp(s_j) - s_i]`` with the
    list in depth-descending order. pred (B, H, W)."""
    b = pred.shape[0]
    k = rankings.shape[-2]
    idx = rankings[..., 0].long().reshape(b, -1)
    s = torch.gather(pred.reshape(b, -1), 1, idx).reshape(-1, k)
    order = torch.argsort(-rankings[..., 1].reshape(-1, k), dim=-1, stable=True)
    s = torch.take_along_dim(s, order, dim=-1)
    lse = torch.logcumsumexp(s.flip(-1), dim=-1).flip(-1)
    return (lse - s).sum(-1).mean()


# -------------------------------------------------------------- optimizer
def sgdr_lr(count: int, max_lr: float, min_lr: float, steps_per_cycle: int) -> torch.Tensor:
    t = torch.tensor(float(count))
    l0 = torch.tensor(float(steps_per_cycle))
    cycle = torch.floor(t / l0)
    frac = torch.clamp((t - cycle * l0) / l0, 0.0, 1.0)
    return min_lr + 0.5 * (torch.tensor(max_lr) - min_lr) * (1.0 + torch.cos(frac * math.pi))


class AmsGrad:
    """optax.amsgrad on a dict of leaves: the max over the bias-corrected
    second moment."""

    def __init__(self, leaves: Dict[str, torch.Tensor], b1=0.9, b2=0.999, eps=1e-7):
        self.b1, self.b2, self.eps, self.count = b1, b2, eps, 0
        self.mu = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.nu_max = {k: torch.zeros_like(v) for k, v in leaves.items()}

    @torch.no_grad()
    def step(self, leaves: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], lr):
        self.count += 1
        c = self.count
        for k, g in grads.items():
            self.mu[k] = self.b1 * self.mu[k] + (1 - self.b1) * g
            self.nu[k] = self.b2 * self.nu[k] + (1 - self.b2) * g * g
            self.nu_max[k] = torch.maximum(self.nu_max[k], self.nu[k] / (1 - self.b2 ** c))
            upd = (self.mu[k] / (1 - self.b1 ** c)) / (torch.sqrt(self.nu_max[k]) + self.eps)
            leaves[k].sub_(lr.to(upd.device) * upd)


# ------------------------------------------------------------------ steps
def run_steps(model: str, params: Dict[str, torch.Tensor], train_names: List[str],
              batch_of: Callable[[int], Dict[str, torch.Tensor]], cfg: dict, seed: int,
              steps: int, steps_per_epoch: int, lowp: Optional[str] = None,
              rows_of: Optional[Callable] = None, batch_sum=None, loss_scale: float = 1.0,
              grad_sum=None, index: int = 0, count: int = 1, remat: bool = False,
              update_sign: float = 1.0) -> dict:
    """``steps`` reference train steps from ``params`` (not modified).
    ``batch_of(step)`` gives the step's {"image", "gt", "mask"} f32 batch on
    the card. Returns each step's loss, the first step's gradient of every
    trainable leaf, every leaf's change after the last step, and the first
    step's depth maps.

    Several processes (``batch_sum`` / ``grad_sum`` all-reduce sums; this
    process holds data index ``index`` of ``count``): BN and the loss over
    the global batch, the gradient summed over the processes. ``remat``
    recomputes each encoder block in the backward pass (memory only).
    ``update_sign`` -1 applies every update with the wrong sign (a fault
    for the signed check)."""
    family = nets.FAMILIES[model][0]
    work = {k: v.clone() for k, v in params.items()}
    leaves = {k: work[k] for k in train_names}
    opt = AmsGrad(leaves)
    sampler = SAMPLER_OF_TYPE[cfg["sampling_type"]]
    cycle = max(1, steps_per_epoch * cfg["epochs"])
    losses, first_grad, first_map = [], None, None
    for step in range(steps):
        b = batch_of(step)
        images, gts, masks = flip(seed, step, b["image"], b["gt"], b["mask"], index, count)
        rankings = sample_rankings(seed, step, gts, masks, sampler, cfg["rankings_per_image"],
                                   cfg["ranking_size"], cfg.get("equality_threshold", 0.03),
                                   index, count)
        for v in leaves.values():
            v.requires_grad_(True)
            v.grad = None
        ctx = nets.Ctx(work, train=True, gen=generator(seed, "train/droppath", step,
                                                       images.device),
                       lowp=lowp, batch_sum=batch_sum, rows=(index, count), remat=remat)
        pred = nets.forward(ctx, model, images)
        if first_map is None:
            first_map = pred.detach().clone()
        loss = listmle_loss(pred, rankings)
        (loss * loss_scale).backward()
        with torch.no_grad():
            grads = {k: v.grad for k, v in leaves.items()}
            if grad_sum is not None:
                grads = grad_sum(grads)
                loss = grad_sum({"loss": loss.detach() * loss_scale})["loss"]
            losses.append(float(loss))
            if first_grad is None:
                first_grad = {k: g.clone() for k, g in grads.items()}
        for v in leaves.values():
            v.requires_grad_(False)
            v.grad = None
        lr = sgdr_lr(step, cfg["initial_lr"], cfg["initial_lr"] * cfg["lr_multi"], cycle)
        opt.step(leaves, grads, lr * update_sign)
    change = {k: (leaves[k] - params[k]).detach() for k in train_names}
    return {"losses": losses, "grad": first_grad, "change": change, "map": first_map}


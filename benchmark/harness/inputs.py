"""Inputs the benchmark makes from ``--seed`` and hands to both the program
and the reference: a depth set (images, ground truth, masks) and model
weights, each made on the card by a ``torch.Generator`` in a few large
calls. The same seed gives the same tensors on the same kind of card."""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference import nets


def card_generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + sum(map(ord, tag)) * 7919) % (2 ** 63 - 1))
    return g


def _fields(g: torch.Generator, n: int, size: int, device, coarse: int = 8) -> torch.Tensor:
    """(n, size, size) smooth random fields scaled to [0, 1]: an 8x8 normal
    field bilinearly resized, per sample min-max normalised."""
    c = torch.randn((n, 1, coarse, coarse), generator=g, device=device)
    f = F.interpolate(c, size=(size, size), mode="bilinear", align_corners=False)[:, 0]
    lo = f.amin(dim=(1, 2), keepdim=True)
    hi = f.amax(dim=(1, 2), keepdim=True)
    return (f - lo) / torch.clamp(hi - lo, min=1e-6)


def depth_set(seed: int, n: int, size: int, device, mask_frac: float = 0.9
              ) -> Dict[str, torch.Tensor]:
    """``n`` samples at ``size``: ``gt`` a smooth inverse depth in (0.05, 1];
    ``image`` its RGB, channel 0 the depth, 1 another smooth field, 2
    uniform noise; ``mask`` 1 on ~``mask_frac`` of the pixels (pixel 0
    always valid). f32 on ``device``."""
    g = card_generator(seed, "depth_set", device)
    gt = 0.05 + 0.95 * _fields(g, n, size, device)
    other = _fields(g, n, size, device)
    noise = torch.rand((n, size, size), generator=g, device=device)
    mask = (torch.rand((n, size, size), generator=g, device=device) < mask_frac).float()
    mask[:, 0, 0] = 1.0
    return {"image": torch.stack([gt, other, noise], dim=-1), "gt": gt, "mask": mask}


def weights(seed: int, model: str, device, batch_stats_images=None) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of ``model`` (the reference's spec), f32 on
    ``device``: conv weights normal with variance 1 / fan-in, conv biases
    and BN shifts N(0, 0.05^2), BN scales 1 + N(0, 0.1^2), running means 0
    and variances 1; the scale of a BN that closes a residual branch is a
    fifth of that (the small-scale start of residual networks: without it
    a random network is chaotic, and a rounding anywhere changes its depth
    maps as much as any fault would). With ``batch_stats_images`` the running statistics
    come from a train-mode forward of the reference over those images,
    layer by layer (:func:`settle_bn`), so inference sees normalised
    activations, as in a trained network."""
    spec = nets.spec(model, 1, 32, device="cpu").spec
    g = card_generator(seed, "weights/" + model, device)
    sizes = [math.prod(s) for _, s, _, _ in spec]
    z = torch.randn((sum(sizes),), generator=g, device=device)
    out = {}
    closers = nets.residual_closers(model)
    for (name, shape, kind, fan_in), chunk in zip(spec, torch.split(z, sizes)):
        chunk = chunk.reshape(shape)
        if kind == "conv":
            out[name] = chunk * (1.0 / math.sqrt(fan_in))
        elif kind in ("bias", "bn_bias"):
            out[name] = chunk * 0.05
        elif kind == "bn_weight":
            out[name] = (1.0 + 0.1 * chunk) * (0.2 if name[:-len(".weight")] in closers
                                               else 1.0)
        elif kind == "bn_mean":
            out[name] = torch.zeros_like(chunk)
        else:
            out[name] = torch.ones_like(chunk)
    if batch_stats_images is not None:
        settle_bn(out, model, batch_stats_images)
    return out


@torch.no_grad()
def settle_bn(params: Dict[str, torch.Tensor], model: str, images: torch.Tensor) -> None:
    """Set every BN's running mean to the batch mean of a train-mode
    reference forward over ``images`` (B, H, W, 3), and its running
    variance to the batch variance plus the mean of the layer's batch
    variances: random filters on smooth images leave some channels almost
    constant, and normalising those by their own variance would amplify
    rounding without bound, which no trained network does."""
    ctx = nets.Ctx(params, train=True, record_stats=True)
    nets.forward(ctx, model, images)
    for name, (m, v) in ctx.stats.items():
        params[f"{name}.running_mean"] = m.contiguous()
        params[f"{name}.running_var"] = (v + v.mean()).contiguous()

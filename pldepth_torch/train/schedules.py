"""Learning-rate schedules as step -> lr functions
(``pldepth_tpu/train/schedules.py``).

Each takes an int or an integer tensor (the optimizer's update count, which
lives on the device) and returns a float32 tensor on the step's device, so
the train step reads its LR without a host round trip. The arithmetic is the
JAX package's, in float32. Its constants are float32 tensors made once per
device (core/device.py ``Constants``): a call makes no host-to-device copy,
so the train step can be captured in a CUDA graph.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from pldepth_torch.core.config import ExperimentConfig
from pldepth_torch.core.device import Constants


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def sgdr_schedule(max_lr: float, min_lr: float, steps_per_cycle: int,
                  lr_decay: float = 1.0, mult_factor: float = 1.0):
    """lr(t) = min + 0.5*(max*decay^c - min)*(1 + cos(pi * frac_in_cycle))."""
    if mult_factor < 1.0:
        raise ValueError(
            f"sgdr mult_factor must be >= 1 (shrinking cycles terminate "
            f"after steps_per_cycle/(1-m) steps); got {mult_factor}")

    consts = {k: Constants(v) for k, v in (("l0", steps_per_cycle), ("m", mult_factor),
                                           ("max", max_lr), ("decay", lr_decay),
                                           ("min", min_lr))}

    def schedule(step) -> torch.Tensor:
        t = _f32(step)
        f32 = lambda k: consts[k].like(t)  # noqa: E731
        l0 = f32("l0")
        if mult_factor == 1.0:
            cycle = torch.floor(t / l0)
            frac = (t - cycle * l0) / l0
        else:
            m = f32("m")
            # cycle c starts at l0*(m^c - 1)/(m - 1)
            cycle = torch.floor(torch.log1p(t * (m - 1.0) / l0) / torch.log(m))
            start = l0 * (torch.pow(m, cycle) - 1.0) / (m - 1.0)
            length = l0 * torch.pow(m, cycle)
            frac = (t - start) / length
        frac = torch.clamp(frac, 0.0, 1.0)
        peak = f32("max") * torch.pow(f32("decay"), cycle)
        return f32("min") + 0.5 * (peak - f32("min")) * (1.0 + torch.cos(frac * math.pi))

    return schedule


def step_decay_schedule(init_lr: float, steps_per_epoch: int,
                        milestones: Sequence[int] = (80, 120, 160, 180),
                        multiplier: float = 0.1, warmup_epochs: int = 0):
    """Epoch-milestone decay with linear warmup, expressed per step."""
    msv, init, mult = Constants(sorted(milestones)), Constants(init_lr), Constants(multiplier)

    def schedule(step) -> torch.Tensor:
        epoch = _f32(step) / float(steps_per_epoch)
        n_hit = (epoch >= msv.like(epoch)).sum().to(torch.float32)
        lr = init.like(epoch) * torch.pow(mult.like(epoch), n_hit)
        if warmup_epochs > 0:
            warm = (torch.floor(epoch) + 1.0) * init_lr / float(warmup_epochs)
            lr = torch.where(epoch < warmup_epochs, warm, lr)
        return lr

    return schedule


def constant_schedule(lr: float):
    value = Constants(lr)
    return lambda step: value.like(_f32(step))


def build_schedule(cfg: ExperimentConfig, steps_per_epoch: int):
    if cfg.schedule == "sgdr":
        # decays to initial_lr * lr_multi (the JAX package's documented fix of
        # the reference's min_lr = initial_lr / lr_multi)
        cycle_epochs = cfg.sgdr_cycle_epochs or cfg.epochs
        return sgdr_schedule(
            max_lr=cfg.initial_lr,
            min_lr=cfg.initial_lr * cfg.lr_multi,
            steps_per_cycle=max(1, steps_per_epoch * cycle_epochs),
            lr_decay=cfg.lr_decay,
            mult_factor=cfg.sgdr_mult_factor,
        )
    if cfg.schedule == "step":
        return step_decay_schedule(
            init_lr=cfg.initial_lr,
            steps_per_epoch=max(1, steps_per_epoch),
            milestones=cfg.step_milestones,
            multiplier=cfg.lr_multi,
            warmup_epochs=cfg.warmup,
        )
    if cfg.schedule == "constant":
        return constant_schedule(cfg.initial_lr)
    raise ValueError(f"unknown schedule {cfg.schedule!r}")

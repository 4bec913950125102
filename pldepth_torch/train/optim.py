"""AMSGrad with optax's semantics (``optax.amsgrad`` under
``optax.multi_transform({"trainable": amsgrad, "frozen": set_to_zero})``,
``pldepth_tpu/train/trainer.py:make_optimizer``).

``torch.optim.Adam(amsgrad=True)`` keeps the max over the raw second moment
and divides by the bias correction afterwards; optax keeps the max over the
bias-corrected one. They differ whenever the gradient scale shrinks, so
this is a small optimizer of its own:

    mu = b1 mu + (1-b1) g;  nu = b2 nu + (1-b2) g^2;  c = count + 1
    nu_max = max(nu_max, nu / (1 - b2^c))
    p += -lr(count) * (mu / (1 - b1^c)) / (sqrt(nu_max) + eps)

Frozen leaves are simply not handed to it (``requires_grad=False``). The
state lives in flat f32 tensors on the device, one element per trainable
parameter element, so a step is a handful of kernels. ``count`` is its own
update counter (optax's), a device tensor: a step that the finite guard
rejects leaves params, moments and count as they were, with no host sync;
the LR of a step is ``schedule(count)``.

``every_k > 1`` (``grad_accum``) is ``optax.MultiSteps(amsgrad,
every_k_schedule=k)``: each micro-step folds its gradient into a running
mean, ``acc += (g - acc) / (mini_step + 1)``; the k-th applies the update
above to ``acc`` and zeroes it, the others leave params and moments
bit-equal. The schedule runs on the micro-step clock, ``schedule(count *
k)``. The finite guard rolls back the whole state, ``mini_step`` and
``acc`` included, as the JAX step's ``where`` over its state does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch


@dataclasses.dataclass
class AmsGradState:
    count: torch.Tensor  # () int32, accepted updates so far
    mu: torch.Tensor  # flat f32 first moment
    nu: torch.Tensor  # flat f32 second moment
    nu_max: torch.Tensor  # flat f32 running max of the bias-corrected nu
    # every_k > 1 only: micro-steps into the cycle, updates emitted, the
    # running mean of the cycle's gradients (optax MultiStepsState)
    mini_step: Optional[torch.Tensor] = None  # () int32
    gradient_step: Optional[torch.Tensor] = None  # () int32
    acc: Optional[torch.Tensor] = None  # flat f32

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in dataclasses.asdict(self).items() if v is not None}

    @classmethod
    def from_state_dict(cls, d: Dict[str, torch.Tensor]) -> "AmsGradState":
        return cls(**{f.name: d.get(f.name) for f in dataclasses.fields(cls)})


class AmsGrad:
    def __init__(self, schedule: Callable, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-7, every_k: int = 1):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.every_k = max(1, int(every_k))

    def inner_schedule(self, count: torch.Tensor) -> torch.Tensor:
        """The LR of the update after ``count`` accepted ones, on the
        micro-step clock."""
        return self.schedule(count * self.every_k if self.every_k > 1 else count)

    def init(self, params: List[torch.Tensor]) -> AmsGradState:
        n = sum(p.numel() for p in params)
        dev = params[0].device if params else torch.device("cpu")
        z = lambda: torch.zeros(n, dtype=torch.float32, device=dev)  # noqa: E731
        i = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
        if self.every_k > 1:
            return AmsGradState(i(), z(), z(), z(), i(), i(), z())
        return AmsGradState(i(), z(), z(), z())

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], state: AmsGradState,
             finite: torch.Tensor) -> torch.Tensor:
        """Apply one (micro-)step from each param's ``.grad`` (a missing grad
        is 0) in place, unless ``finite`` is False or a grad is not finite;
        then params and state keep their values. Returns the combined flag."""
        b1, b2 = self.b1, self.b2
        g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                       for p in params]).to(torch.float32)
        finite = finite & torch.isfinite(g).all()
        commit = finite
        if self.every_k > 1:
            acc = state.acc + (g - state.acc) / (state.mini_step + 1).to(torch.float32)
            emit = state.mini_step == self.every_k - 1
            commit = finite & emit
            g = acc
        mu = (1 - b1) * g + b1 * state.mu
        nu = (1 - b2) * torch.square(g) + b2 * state.nu
        count_inc = state.count + 1
        c = count_inc.to(torch.float32)
        nu_max = torch.maximum(state.nu_max, nu / (1 - b2 ** c))
        update = (mu / (1 - b1 ** c)) / (torch.sqrt(nu_max) + self.eps)
        update = -self.inner_schedule(state.count) * update
        flat = torch.cat([p.reshape(-1) for p in params])
        new = torch.where(commit, flat + update, flat)
        torch._foreach_copy_(params, [v.view_as(p) for v, p in
                                      zip(new.split([p.numel() for p in params]), params)])
        for old, upd in ((state.mu, mu), (state.nu, nu), (state.nu_max, nu_max),
                         (state.count, count_inc)):
            old.copy_(torch.where(commit, upd, old))
        if self.every_k > 1:
            for old, upd in ((state.acc, torch.where(emit, torch.zeros_like(acc), acc)),
                             (state.mini_step, (state.mini_step + 1) % self.every_k),
                             (state.gradient_step, state.gradient_step + emit.to(torch.int32))):
                old.copy_(torch.where(finite, upd, old))
        return finite

"""Ordinal depth relation with the WHDR ratio test
(``pldepth_tpu/sampling/relations.py``): +1 if d1/d2 >= 1+tau, -1 if
d1/d2 <= 1/(1+tau), else 0, with a 1e-10 guard on both depths; the sign of
d1 - d2 when ``threshold`` is None."""

from __future__ import annotations

import torch

_EPS = 1e-10


def depth_relation(d1, d2, threshold: float | None = None) -> torch.Tensor:
    """Elementwise ordinal relation in {-1, 0, +1} (int8)."""
    d1 = torch.as_tensor(d1, dtype=torch.float32)
    d2 = torch.as_tensor(d2, dtype=torch.float32)
    if threshold is None:
        return torch.sign(d1 - d2).to(torch.int8)
    ratio = (d1 + _EPS) / (d2 + _EPS)
    hi = 1.0 + threshold
    one = torch.ones_like(ratio, dtype=torch.int8)
    rel = torch.where(ratio >= hi, one, torch.where(ratio <= 1.0 / hi, -one, 0 * one))
    return rel

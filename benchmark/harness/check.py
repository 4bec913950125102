"""The numbers that decide ``correct``, each with its limit.

Training: the first step's depth maps and loss; the norm of the first
gradient as the optimizer got it; the norm of every leaf's change after
the checked steps; the direction of the whole change. A gap of norms is
taken leaf by leaf, against the reference's norm of that leaf or of the
median leaf, whichever is larger; the median leaf's gap and the worst
leaf's are read. Leaves whose reference gradient is under a thousandth of
the median leaf's are left out of the change (they move by round-off
alone under AMSGrad). The set of trained leaves is compared exactly.

Serving: for each sampled image, the RMS of the gap between the served
depth map and the reference's, over the standard deviation of the
reference's map; the worst image is the number."""

from __future__ import annotations

import math
from typing import Dict, List

import torch


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _gaps(got: Dict[str, float], want: Dict[str, float], names: List[str]) -> List[float]:
    """Each leaf's gap of norms, against the reference's norm of that leaf
    or of the median leaf, whichever is larger."""
    if not names:
        return [0.0]
    med = sorted(want[n] for n in names)[len(names) // 2]
    return [abs(got[n] - want[n]) / max(want[n], med, 1e-30) for n in names]


def _median(xs: List[float]) -> float:
    return sorted(xs)[len(xs) // 2]


def train_numbers(losses: List[float], grad: Dict[str, torch.Tensor],
                  change: Dict[str, torch.Tensor], first_map: torch.Tensor,
                  ref: dict) -> Dict[str, float]:
    """``losses``, ``grad``, ``change``, ``first_map``: the program's;
    ``ref``: run_steps'.

    ``map``: the first step's train-mode depth maps, as ``serve_number``.
    ``loss``: the first step's loss, relative gap. ``grad``, ``grad_worst``:
    the median and the worst leaf's gap of first-gradient norms.
    ``change``, ``change_worst``: the same of the norms of the change over
    the checked steps, among the leaves that the reference's gradient
    moves. ``turn``: one less the cosine between the program's whole change
    and the reference's over those leaves (0 alike, 1 at right angles, 2 an
    update of the wrong sign), which no norm sees."""
    names = list(ref["grad"])
    g_ref = {n: _norm(ref["grad"][n]) for n in names}
    g_got = {n: _norm(grad[n]) if n in grad else 0.0 for n in names}
    med = _median(list(g_ref.values()))
    moving = [n for n in names if g_ref[n] >= 1e-3 * med]
    c_ref = {n: _norm(ref["change"][n]) for n in moving}
    c_got = {n: _norm(change[n]) if n in change else 0.0 for n in moving}
    g_gaps, c_gaps = _gaps(g_got, g_ref, names), _gaps(c_got, c_ref, moving)
    dot = sum(float(torch.sum(change[n].double() * ref["change"][n].double()))
              for n in moving if n in change)
    both = math.sqrt(sum(c_got[n] ** 2 for n in moving)) * math.sqrt(
        sum(c_ref[n] ** 2 for n in moving))
    return {"map": serve_number(first_map, ref["map"]),
            "loss": abs(losses[0] - ref["losses"][0]) / max(abs(ref["losses"][0]), 1e-30),
            "grad": _median(g_gaps), "grad_worst": max(g_gaps),
            "change": _median(c_gaps), "change_worst": max(c_gaps),
            "turn": 1.0 - dot / both if both > 0 else 1.0}


def train_detail(grad: Dict[str, torch.Tensor], ref: dict) -> dict:
    """Where the training numbers come from (for the readings, not judged):
    the leaves with the worst first-gradient gaps, and the share of
    gradient elements whose sign differs from the reference's (AMSGrad's
    first update is lr times that sign)."""
    names = [n for n in ref["grad"] if n in grad]
    g_ref = {n: _norm(ref["grad"][n]) for n in names}
    med = _median(list(g_ref.values())) if names else 0.0
    rows = sorted(((abs(_norm(grad[n]) - g_ref[n]) / max(g_ref[n], med, 1e-30), n)
                   for n in names), reverse=True)
    flips = sum(int((torch.sign(grad[n]) != torch.sign(ref["grad"][n])).sum()) for n in names)
    total = sum(grad[n].numel() for n in names)
    return {"grad_worst_leaves": [[n, gap] for gap, n in rows[:5]],
            "sign_flips": flips / max(total, 1)}


def serve_number(got: torch.Tensor, want: torch.Tensor) -> float:
    """got, want: (N, H, W) maps: the worst map's RMS gap over the
    reference map's standard deviation (over the maps both have)."""
    n = min(got.shape[0], want.shape[0])
    got, want = got[:n].reshape(want[:n].shape), want[:n]
    d = (got.double() - want.double()).flatten(1)
    w = want.double().flatten(1)
    rms = torch.sqrt(torch.mean(d * d, dim=1))
    return float(torch.max(rms / torch.clamp(w.std(dim=1), min=1e-30)))


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that the cell's limits name is there and within its
    limit. A number without a limit is read and not compared (its readings
    showed no limit that separates sound runs from the faults)."""
    return all(k in numbers and numbers[k] == numbers[k] and numbers[k] <= v
               for k, v in limits.items())


def describe(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """The compared numbers, each beside its limit."""
    return {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}

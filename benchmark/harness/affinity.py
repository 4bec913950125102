"""Disjoint sets of the cores a run may use, one for each rank, and the
thread counts each rank gets."""

from __future__ import annotations

import os
from typing import List


def allowed() -> List[int]:
    return sorted(os.sched_getaffinity(0))


def split(cores: List[int], ranks: int) -> List[List[int]]:
    """``ranks`` disjoint, contiguous, near-equal slices of ``cores`` (each
    at least one core; ranks share round-robin when there are fewer cores
    than ranks)."""
    if ranks < 1:
        raise ValueError("ranks must be positive")
    if len(cores) < ranks:
        return [[cores[r % len(cores)]] for r in range(ranks)]
    base, extra = divmod(len(cores), ranks)
    out, i = [], 0
    for r in range(ranks):
        n = base + (1 if r < extra else 0)
        out.append(cores[i:i + n])
        i += n
    return out


def thread_env(cores: List[int]) -> dict:
    n = str(max(1, len(cores)))
    return {"OMP_NUM_THREADS": n, "MKL_NUM_THREADS": n, "OPENBLAS_NUM_THREADS": n}

"""Partial-ranking combination matrices (``pldepth_tpu/data/partial.py``):
Plackett-Luce with tied segments.

A copy of the JAX package's host numpy, bit-equal. The reference's
declared-but-unused machinery for rankings with ties
(pldepth/data/providers/hourglass_provider.py:95-165:
``construct_combination_matrix_np`` and its ragged-TF twin): a ranking whose
elements are grouped into tied *segments* (segment id per element, ordered
best-first) needs, for the P-L likelihood with ties, the enumeration of all
non-empty subsets of every tail suffix of segments. Per unique segment id k
the result is a 0/1 matrix with one row per non-empty subset of the elements
whose segment id is >= k, columns indexed over the full list. Subset rows
follow ``itertools.product([0, 1], repeat=m)`` order minus the all-zero row,
the reference's order. A library API: nothing in either package calls it.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def _nonzero_binary_rows(m: int) -> np.ndarray:
    """(2^m - 1, m) all non-zero binary vectors in itertools.product order.

    product([0,1], repeat=m) counts up in binary with the first position as
    the most-significant bit; the all-zero row is its first element
    (reference removes it, hourglass_provider.py:116-118).
    """
    if m <= 0:
        return np.zeros((0, 0), np.int32)
    if m > 20:
        raise ValueError(f"2^{m} subset rows is past any sane bound")
    counts = np.arange(1, 2**m, dtype=np.int64)
    shifts = np.arange(m - 1, -1, -1, dtype=np.int64)
    return ((counts[:, None] >> shifts) & 1).astype(np.int32)


def combination_matrix(segment_ids: Sequence[int]) -> List[np.ndarray]:
    """Per unique segment id, the non-empty-subset indicator matrix.

    Args:
      segment_ids: length-K sequence, the tied-segment id of each ranking
        element (reference ``segments[:, 1]``).

    Returns:
      One (2^m_k - 1, K) int32 array per unique id k (ascending), where
      m_k = #elements with id >= k; columns outside that tail are zero
      (reference construct_combination_matrix_np, hourglass_provider.py:104-123).
    """
    ids = np.asarray(segment_ids)
    k = ids.shape[0]
    out: List[np.ndarray] = []
    for uid in np.unique(ids):
        mask = ids >= uid
        rows = _nonzero_binary_rows(int(mask.sum()))
        full = np.zeros((rows.shape[0], k), np.int32)
        full[:, mask] = rows
        out.append(full)
    return out


def batch_combination_matrix(batch_segments: np.ndarray) -> List[List[np.ndarray]]:
    """Batch wrapper (reference construct_batch_combination_matrix,
    hourglass_provider.py:96-102): ``batch_segments`` is (B, K, 2) with
    segment ids in column 1."""
    return [combination_matrix(batch_segments[i][:, 1]) for i in range(batch_segments.shape[0])]

"""The split of a run's cores over the ranks of a multi-card cell."""

import pytest

from benchmark.harness import affinity


@pytest.mark.parametrize("n, ranks", [(8, 4), (32, 4), (7, 4), (4, 4), (1, 1), (9, 2)])
def test_split_is_disjoint_and_covers(n, ranks):
    cores = list(range(100, 100 + n))
    parts = affinity.split(cores, ranks)
    assert len(parts) == ranks
    flat = [c for p in parts for c in p]
    assert sorted(flat) == cores and len(set(flat)) == len(flat)
    sizes = [len(p) for p in parts]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1


def test_fewer_cores_than_ranks_share():
    parts = affinity.split([0, 1], 4)
    assert [len(p) for p in parts] == [1, 1, 1, 1]


def test_thread_env_matches_cores():
    env = affinity.thread_env([3, 4, 5])
    assert env["OMP_NUM_THREADS"] == "3"


def test_allowed_is_this_process_affinity():
    assert affinity.allowed() and all(isinstance(c, int) for c in affinity.allowed())

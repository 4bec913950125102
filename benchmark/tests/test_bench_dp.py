"""The four-rank cell's check on the CPU: four processes over gloo, the
program's data-parallel step at a small size in float32 against the
reference's (global-batch BN and the gradient summed over the ranks by
plain ``torch.distributed``): a sound run agrees, and one with the
exchange between ranks left out does not."""

import copy
import json
import socket
import time

import pytest
import torch.multiprocessing as mp

from benchmark.harness import check, manifest

WORKLOAD = "effnetb4-640-train-dp4-g128"


def _port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(rank, port, fault, path):
    import torch

    from benchmark.harness import train_cell

    torch.set_num_threads(1)
    cell = copy.deepcopy(manifest.cell(WORKLOAD))
    cell["config"].update(input_size=64, compute_dtype="float32")
    cell["traffic"].update(batch_size=8, images=16, warm_steps=5)
    cell["init_method"] = f"tcp://127.0.0.1:{port}"
    out = train_cell.run(cell, 3_123_456_789, 0.3, False, time.time(), {}, world=4, rank=rank,
                         device="cpu", fault=fault)
    if rank == 0:
        with open(path, "w") as f:
            json.dump(out["numbers"], f)


def _numbers(tmp_path, fault):
    path = str(tmp_path / "numbers.json")
    mp.spawn(_child, args=(_port(), fault, path), nprocs=4, join=True)
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_four_ranks(tmp_path, fault):
    if WORKLOAD not in {w["name"] for w in manifest.load()["workloads"]}:
        pytest.skip("the four-card cell is not in BENCHMARK.json")
    limits = manifest.cell(WORKLOAD)["limits"]
    numbers = _numbers(tmp_path, fault)
    assert check.judge(numbers, limits) == (fault is None), numbers

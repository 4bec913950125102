"""The comparison that decides ``correct``, driven through the rest of a
run on the CPU at a small size (the program in float32 there, where it
agrees with the reference to rounding): a sound run passes the cell's
committed limits; the timed path broken underneath fails them; the
control (the reference at the precision below the configuration's) reads
far above the sound run. The same at the cells' own sizes on the card:
``cuda``-marked tests."""

import copy
import time

import pytest
import torch

from benchmark.harness import check, manifest, serve_cell, train_cell

SEED = 2_987_654_321


def _small(name, size=64, dtype="float32"):
    cell = copy.deepcopy(manifest.cell(name))
    cell["config"].update(input_size=size, compute_dtype=dtype)
    cell["traffic"].update(batch_size=4, images=16, warm_steps=5, warm_chunks=2)
    return cell


def _train(name, fault=None):
    cell = _small(name)
    out = train_cell.run(cell, SEED, 0.5, False, time.time(), {}, device="cpu", fault=fault)
    return cell, out["numbers"]


@pytest.mark.parametrize("name", ["effnet448-train-b32", "redweb448-train-b32"])
def test_sound_train_run_is_correct(name):
    cell, numbers = _train(name)
    assert check.judge(numbers, cell["limits"]), numbers


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "sign_flip"])
def test_broken_train_step_is_not_correct(fault):
    cell, numbers = _train("effnet448-train-b32", fault)
    assert not check.judge(numbers, cell["limits"]), numbers


def test_train_control_reads_far_above_a_sound_run():
    cell = _small("effnet448-train-b32")
    sound = _train("effnet448-train-b32")[1]
    ctrl = train_cell.variant_numbers(cell, SEED, torch.device("cpu"), lowp="fp8")
    assert ctrl["map"] > 5 * sound["map"] and ctrl["map"] > cell["limits"]["map"]


def _serve(fault=None):
    cell = _small("effnet448-serve-int8-b32", dtype="float32")
    out = serve_cell.run(cell, SEED, 0.5, False, time.time(), {}, device="cpu", fault=fault)
    return cell, out["numbers"]


def test_serving_altered_answer_is_not_correct():
    cell, sound = _serve()
    _, broken = _serve("altered")
    assert broken["map_gap"] > cell["limits"]["map_gap"] > sound["map_gap"]


def test_serving_control_reads_far_above_the_program():
    cell, sound = _serve()
    ctrl = serve_cell.variant_numbers(cell, SEED, torch.device("cpu"), bits=4)
    assert ctrl["map_gap"] > 5 * sound["map_gap"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells' own sizes")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["effnet448-train-b32", "redweb448-train-b32"])
def test_train_control_fails_at_the_cell_size(card, name):
    cell = manifest.cell(name)
    ctrl = train_cell.variant_numbers(cell, SEED, card, lowp="fp8")
    assert not check.judge(ctrl, cell["limits"]), ctrl


@pytest.mark.cuda
def test_serving_control_fails_at_the_cell_size(card):
    cell = manifest.cell("effnet448-serve-int8-b32")
    ctrl = serve_cell.variant_numbers(cell, SEED, card, bits=4)
    assert not check.judge(ctrl, cell["limits"]), ctrl

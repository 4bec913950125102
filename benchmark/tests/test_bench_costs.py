"""The operation and byte arithmetic behind ``mfu.*`` and ``*_roofline.*``
at small shapes, worked out by hand."""

import math

import pytest

from benchmark.harness import costs
from benchmark.reference import nets


def test_conv_ops_by_hand():
    c = {"n": 2, "ho": 3, "wo": 5, "cout": 7, "cin": 4, "groups": 1, "k": 3}
    assert costs.conv_ops(c) == 2 * 2 * 3 * 5 * 7 * 4 * 9
    c.update(groups=4, cout=4)
    assert costs.conv_ops(c) == 2 * 2 * 3 * 5 * 4 * 1 * 9


def test_spec_records_every_conv_once():
    ctx = nets.spec("ff_effnet", 1, 64)
    names = [c["name"] for c in ctx.convs]
    assert len(names) == len(set(names))
    assert sum(1 for n, *_ in ctx.spec if n.endswith(".weight") and "bn" not in n) >= len(names)
    # the stem of B0: 3 -> 32 channels, 3x3, stride 2, SAME: 64 -> 32
    stem = ctx.convs[0]
    assert (stem["cin"], stem["cout"], stem["k"], stem["ho"]) == (3, 32, 3, 32)


@pytest.mark.parametrize("freeze", [True, False])
def test_train_ops_counts_forward_dgrad_wgrad(freeze):
    ctx = nets.spec("ff_effnet", 2, 64)
    fwd = sum(costs.conv_ops(c) for c in ctx.convs)
    dgrad = fwd - costs.conv_ops(ctx.convs[0])
    wgrad = sum(costs.conv_ops(c) for c in ctx.convs
                if not (freeze and c["name"].startswith("encoder.")))
    assert costs.train_ops("ff_effnet", 2, 64, freeze) == pytest.approx(fwd + dgrad + wgrad)


def test_k1_least_time_by_hand():
    n, k = 3200, 5
    fwd = max((20 * n * k + 4 * n + 4) / costs.HBM_BYTES_PER_S,
              n * k * (math.log2(k) + 12) / costs.PEAK_F32)
    bwd = max((16 * n * k + 4) / costs.HBM_BYTES_PER_S, 14 * n * k / costs.PEAK_F32)
    assert costs.k1_least_s(n, k) == pytest.approx(fwd + bwd)


def test_k4_sites_and_least_time():
    sites = costs.k4_sites("ff_effnet", 1, 64)
    assert len(sites) == 38  # stem, 15 expands, 16 projects, top, 5 decoder convs
    stem = sites[0]
    assert (stem["m"], stem["k"], stem["n"], stem["window"]) == (32 * 32, 27, 32, True)
    # one site by hand: bytes (the input in place, weight, scales, bias,
    # bf16 output) against int8 operations
    m, k, n = stem["m"], stem["k"], stem["n"]
    nbytes = min(stem["in"], m * k) + k * n + 8 * n + 4 + 2 * m * n
    want = max(nbytes / costs.HBM_BYTES_PER_S, 2 * m * k * n / costs.PEAK_INT8)
    assert want <= costs.k4_least_s("ff_effnet", 1, 64)
    assert costs.k4_least_s("ff_effnet", 4, 64) > costs.k4_least_s("ff_effnet", 1, 64)


def test_serve_least_splits_int8_and_bf16():
    ctx = nets.spec("ff_effnet", 1, 64)
    i8 = sum(costs.conv_ops(c) for c in ctx.convs if c["site"] and c["groups"] == 1)
    rest = sum(costs.conv_ops(c) for c in ctx.convs) - i8
    assert costs.serve_least_s("ff_effnet", 1, 64) == pytest.approx(
        i8 / costs.PEAK_INT8 + rest / costs.PEAK_BF16)


@pytest.mark.parametrize("model, size", [("ff_effnet", 448), ("ff_redweb", 448),
                                         ("ff_effnet_b4", 640)])
def test_scaled_records_equal_the_full_size_forward(model, size):
    assert costs.convs(model, 2, size) == nets.spec(model, 2, size).convs

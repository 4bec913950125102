"""The window read of K4's convolution entry point, on the CPU.

The CUDA kernel (``pldepth_torch/csrc/quant_matmul.cu``) cannot run here;
what surrounds its tensor-core product can:

* ``pack_weight``: the K-major (N, Kp) weight the kernel reads equals
  ``kernel_q.reshape(K, N).T`` with K zero-padded to ``K_STEP``, and
  round-trips;
* the window read as a sum over taps (``acc += shifted q at tap (i, j) @
  W[i, j]``, zeros outside the image) equals ``im2col_same`` + an int64
  product exactly, and equals the JAX int8 convolution
  (``lax.conv_general_dilated``, ``preferred_element_type=int32``);
* the kernel's A loader, re-stated in numpy with the same integer
  arithmetic (row origins decoded once, the K index advanced tap by tap, a
  zero for every request outside the image or past K), times the packed
  weight equals the same product exactly, at each loader width;
* a stem's 3 channels padded to 4 (``pack_kernel``, and the activation as
  the card's wrapper pads it) give the same sums through the 4-byte loader;
* ``QuantConv`` keeps one pack per value of ``kernel_q``; the CPU route of
  ``quant_conv2d`` is ``im2col_same`` + K4's plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from pldepth_torch.models.quantize import QuantConv
from pldepth_torch.ops.conv import conv_pads
from pldepth_torch.ops.quant_conv import (
    CIN_ALIGN,
    _out_hw,
    im2col_same,
    pack_kernel,
    quant_conv2d,
    quant_conv2d_plain,
)
from pldepth_torch.ops.quant_matmul import K_STEP, pack_weight, quant_matmul_plain

torch.set_num_threads(1)
KS = [(1, 1), (1, 2), (3, 1), (3, 2), (7, 1), (7, 2)]  # (window, stride)
HWS = [(9, 12), (8, 7)]  # odd and even heights and widths
CINS = [3, 24, 64]


def _operands(k, cin, cout, hw, batch=2, seed=0):
    rng = np.random.default_rng(seed + 7 * k + cin)
    q = rng.integers(-127, 128, (batch, *hw, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    return torch.from_numpy(q), torch.from_numpy(w)


def _im2col_acc(q, w, stride, padding):
    k, _, cin, cout = w.shape
    cols = im2col_same(q, k, stride, padding)
    return cols.to(torch.int64) @ w.reshape(k * k * cin, cout).to(torch.int64)


def window_read_taps(q, w, stride, padding):
    """The convolution as the kernel's window read sums it: one product per
    tap (i, j) of the input shifted to that tap, zeros outside the image."""
    b, h, wd, cin = q.shape
    k, _, _, cout = w.shape
    ho, wo, (pl, _, pt, _) = _out_hw(h, wd, k, stride, padding)
    acc = torch.zeros((b, ho, wo, cout), dtype=torch.int64)
    hi0 = torch.arange(ho) * stride - pt
    wi0 = torch.arange(wo) * stride - pl
    for i in range(k):
        for j in range(k):
            hi, wi = hi0 + i, wi0 + j
            inside = ((hi >= 0) & (hi < h))[:, None] & ((wi >= 0) & (wi < wd))[None, :]
            tap = q[:, hi.clamp(0, h - 1)][:, :, wi.clamp(0, wd - 1)].to(torch.int64)
            tap = tap * inside[None, :, :, None]
            acc += tap @ w[i, j].to(torch.int64)
    return acc.reshape(b * ho * wo, cout)


def kernel_loader(q, k, stride, padding, width):
    """The (M, Kp) A operand as csrc/quant_matmul.cu's ``load_stage`` fills
    it, in the kernel's integer arithmetic: ``width`` bytes a request."""
    b, h, wd, cin = q.shape
    ho, wo, (pl, _, pt, _) = _out_hw(h, wd, k, stride, padding)
    m, kk_total = b * ho * wo, k * k * cin
    kp = -(-kk_total // K_STEP) * K_STEP
    flat = q.reshape(-1).numpy()
    rows = np.arange(m)
    bi, rem = rows // (ho * wo), rows % (ho * wo)
    hi = rem // wo * stride - pt
    wi = rem % wo * stride - pl
    base = ((bi * h + hi) * wd + wi) * cin
    a = np.zeros((m, kp), np.int8)
    for cv in range(K_STEP // width):
        kk = cv * width
        tap = kk // cin
        tc, ti, tj = kk - tap * cin, tap // k, tap % k
        for _ in range(kp // K_STEP):
            koff = (ti * wd + tj) * cin + tc
            valid = (kk < kk_total) & (hi + ti >= 0) & (hi + ti < h) & (wi + tj >= 0) & (wi + tj < wd)
            for byte in range(width):
                src = np.where(valid, base + koff + byte, 0)
                a[:, kk + byte] = np.where(valid, flat[src], 0)
            kk += K_STEP
            tc += K_STEP
            while tc >= cin:
                tc -= cin
                tj += 1
                if tj == k:
                    tj, ti = 0, ti + 1
    return a


@pytest.mark.parametrize("shape", [(27, 5), (64, 16), (147, 64), (250, 37), (1, 1), (128, 8)])
def test_pack_weight_is_the_transposed_matrix_zero_padded(shape):
    k, n = shape
    w = torch.from_numpy(np.random.default_rng(k).integers(-127, 128, (k, n)).astype(np.int8))
    packed = pack_weight(w)
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert packed.shape == (n, -(-k // K_STEP) * K_STEP) and packed.shape[1] % K_STEP == 0
    assert torch.equal(packed[:, :k], w.t())
    assert not packed[:, k:].any()
    assert torch.equal(packed[:, :k].t(), w)  # round trip


@pytest.mark.parametrize("k,cin,cout", [(1, 24, 40), (3, 3, 32), (3, 64, 16), (7, 3, 64)])
def test_pack_weight_of_hwio_runs_row_column_channel(k, cin, cout):
    _, w = _operands(k, cin, cout, (4, 4))
    packed = pack_weight(w)
    kk = k * k * cin
    assert torch.equal(packed[:, :kk], w.reshape(kk, cout).t())
    assert torch.equal(packed, pack_weight(w.reshape(kk, cout)))
    # a non-contiguous HWIO view packs to the same bytes
    assert torch.equal(pack_weight(w.permute(1, 0, 2, 3).permute(1, 0, 2, 3)), packed)


@pytest.mark.parametrize("k,stride", KS)
@pytest.mark.parametrize("explicit", [False, True])
@pytest.mark.parametrize("hw", HWS)
@pytest.mark.parametrize("cin", CINS)
def test_window_read_by_taps_equals_im2col_exactly(k, stride, explicit, hw, cin):
    padding = k // 2 if explicit else None
    q, w = _operands(k, cin, 5, hw)
    want = _im2col_acc(q, w, stride, padding)
    got = window_read_taps(q, w, stride, padding)
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("k,stride", KS)
@pytest.mark.parametrize("hw", HWS)
def test_window_read_by_taps_equals_the_jax_int8_conv(k, stride, hw):
    q, w = _operands(k, 3, 8, hw, seed=1)
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(q.numpy()), jnp.asarray(w.numpy()), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))
    got = window_read_taps(q, w, stride, None).numpy().reshape(want.shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,stride", KS)
@pytest.mark.parametrize("explicit", [False, True])
@pytest.mark.parametrize("cin,width", [(3, 1), (24, 8), (40, 8), (64, 16), (16, 16), (64, 1)])
def test_kernel_loader_times_the_pack_equals_im2col_exactly(k, stride, explicit, cin, width):
    padding = k // 2 if explicit else None
    q, w = _operands(k, cin, 6, (9, 8), seed=2)
    a = kernel_loader(q, k, stride, padding, width)
    packed = pack_weight(w)
    assert a.shape[1] == packed.shape[1]
    got = torch.from_numpy(a).to(torch.int64) @ packed.t().to(torch.int64)
    assert torch.equal(got, _im2col_acc(q, w, stride, padding))
    # and the operand itself is the patch matrix, zero past K
    cols = im2col_same(q, k, stride, padding)
    assert torch.equal(torch.from_numpy(a)[:, : cols.shape[1]], cols)
    assert not a[:, cols.shape[1]:].any()


@pytest.mark.parametrize("k,stride,explicit", [(3, 2, False), (7, 2, True), (3, 1, False), (1, 1, False)])
@pytest.mark.parametrize("cin", [3, 5, 6])
def test_channels_padded_to_the_request_width_give_the_same_sums(k, stride, explicit, cin):
    padding = k // 2 if explicit else None
    q, w = _operands(k, cin, 7, (9, 8), seed=5)
    packed = pack_kernel(w)
    cin_p = -(-cin // CIN_ALIGN) * CIN_ALIGN
    assert packed.shape == (7, -(-k * k * cin_p // K_STEP) * K_STEP)
    wp = torch.nn.functional.pad(w, (0, 0, 0, cin_p - cin))
    assert torch.equal(packed, pack_weight(wp))
    qp = torch.nn.functional.pad(q, (0, cin_p - cin))  # as quant_conv2d pads it on the card
    a = kernel_loader(qp, k, stride, padding, CIN_ALIGN)
    got = torch.from_numpy(a).to(torch.int64) @ packed.t().to(torch.int64)
    assert torch.equal(got, _im2col_acc(q, w, stride, padding))


def test_pack_kernel_leaves_aligned_channels_alone():
    _, w = _operands(3, 24, 8, (4, 4))
    assert torch.equal(pack_kernel(w), pack_weight(w))


@pytest.mark.parametrize("m,kk", [(130, 70), (65, 4), (97, 27), (64, 256)])
def test_kernel_loader_as_a_plain_product(m, kk):
    # the matmul entry point: a 1x1 window over an (M, 1) image of K channels
    x = torch.from_numpy(np.random.default_rng(m).integers(-127, 128, (m, kk)).astype(np.int8))
    width = 16 if kk % 16 == 0 else 8 if kk % 8 == 0 else 1
    a = kernel_loader(x.reshape(1, m, 1, kk), 1, 1, None, width)
    assert torch.equal(torch.from_numpy(a)[:, :kk], x) and not a[:, kk:].any()


@pytest.mark.parametrize("k,stride,padding", [(3, 1, None), (3, 2, None), (7, 2, 3), (1, 2, None)])
@pytest.mark.parametrize("act", [None, "swish", "relu"])
def test_cpu_route_of_quant_conv2d_is_im2col_plus_plain(k, stride, padding, act):
    q, w = _operands(k, 24, 12, (10, 9), seed=3)
    rng = np.random.default_rng(4)
    ws = torch.from_numpy((rng.random(12) * 0.01 + 1e-3).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(12).astype(np.float32) * 0.1)
    before = im2col_same.calls
    got = quant_conv2d(q, w, ws, bias, 0.02, stride, torch.float32, padding, act,
                       w_packed=pack_kernel(w))
    assert im2col_same.calls == before + 1
    ho, wo, _ = _out_hw(10, 9, k, stride, padding)
    want = quant_matmul_plain(im2col_same(q, k, stride, padding), w.reshape(-1, 12), ws, bias,
                              0.02, act, torch.float32).reshape(2, ho, wo, 12)
    assert torch.equal(got, want)
    assert torch.equal(got, quant_conv2d_plain(q, w, ws, bias, 0.02, stride, torch.float32,
                                               padding, act))
    assert quant_conv2d.window_launches == 0  # no kernel launch without a card


def test_quant_conv2d_refuses_what_it_does_not_take():
    q, w = _operands(3, 8, 4, (6, 6))
    ws, bias = torch.ones(4), torch.zeros(4)
    with pytest.raises(ValueError, match="square"):
        quant_conv2d(q, w[:, :2], ws, bias, 1.0)
    with pytest.raises(ValueError, match="channels"):
        quant_conv2d(q[..., :5], w, ws, bias, 1.0)
    with pytest.raises(ValueError, match="NHWC"):
        quant_conv2d(q[0], w, ws, bias, 1.0)


@pytest.mark.parametrize("k,padding", [(3, None), (7, 3), (1, None)])
def test_explicit_and_same_pads_reach_the_loader(k, padding):
    pl, _, pt, _ = conv_pads(9, 12, k, 2, padding)
    _, _, (gl, _, gt, _) = _out_hw(9, 12, k, 2, padding)
    assert (pl, pt) == (gl, gt)
    if padding is not None:
        assert (pl, pt) == (padding, padding)


def test_quantconv_packs_once_and_repacks_when_kernel_q_changes():
    site = QuantConv(8, 4, 3, dtype=torch.float32)
    _, w = _operands(3, 8, 4, (4, 4))
    site.kernel_q.copy_(w)
    first = site.packed_weight()
    assert torch.equal(first, pack_weight(w))
    assert site.packed_weight() is first  # made once per value of the buffers
    site.kernel_q.neg_()  # in place: the version counter moves
    second = site.packed_weight()
    assert second is not first and torch.equal(second, pack_weight(-w))
    site.load_state_dict({**site.state_dict(), "kernel_q": w.clone()}, assign=True)
    assert torch.equal(site.packed_weight(), pack_weight(w))  # a new tensor: another data_ptr
    assert len(site.derived()) == 3


@pytest.mark.parametrize("groups,calibrate", [(8, False), (1, True)])
def test_only_dense_int8_sites_keep_a_pack(groups, calibrate):
    site = QuantConv(8, 8, 3, groups=groups, calibrate=calibrate, dtype=torch.float32)
    assert site.packed_weight() is None

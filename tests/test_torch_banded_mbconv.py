"""K3, the banded two-pass inference MBConv: the port's plain version (the
band algorithm the CUDA kernel carries) against the JAX package's
``banded_mbconv_infer`` (the Pallas kernels in interpret mode) on the six
cases of tests/test_banded_mbconv.py and its bf16 band-invariance case, from
the same seeded numpy inputs. f32 at rtol = atol = 3e-5. The CUDA kernel
itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pldepth_torch.ops import banded_mbconv as tk
from pldepth_torch.ops import fused_mbconv as k2
from pldepth_tpu.ops import banded_mbconv as jk
from pldepth_tpu.ops.fused_mbconv import MBConvParams as JParams

torch.set_num_threads(1)

# (kernel, stride, expand, residual, band): tests/test_banded_mbconv.py:35-61
CASES = [(3, 1, True, True, 4), (3, 2, True, False, 4), (5, 1, True, True, 8),
         (5, 2, True, False, 2), (3, 1, False, False, 4), (3, 1, True, True, 16)]


def _params(seed, cin, ce, cout, k, cse, expand=True):
    rng = np.random.default_rng(seed)
    f = lambda shape, s=0.2: (rng.normal(size=shape) * s).astype(np.float32)  # noqa: E731
    return dict(
        we=f((cin, ce)) if expand else None,
        e_scale=1.0 + f((ce,), 0.05) if expand else None,
        e_shift=f((ce,), 0.05) if expand else None,
        dw=f((k, k, ce)), d_scale=1.0 + f((ce,), 0.05), d_shift=f((ce,), 0.05),
        se_w1=f((ce, cse)), se_b1=f((cse,)), se_w2=f((cse, ce)), se_b2=f((ce,)),
        wp=f((ce, cout)), p_scale=1.0 + f((cout,), 0.05), p_shift=f((cout,), 0.05),
    )


def _both(k, expand, seed=0, hw=(16, 24), batch=2, ce_mult=6):
    cin = cout = 8
    ce = cin * (ce_mult if expand else 1)
    p = _params(seed + 1, cin, ce, cout, k, 4, expand)
    x = np.random.default_rng(seed).normal(size=(batch, *hw, cin)).astype(np.float32)
    tp = tk.MBConvParams(**{n: None if v is None else torch.from_numpy(v) for n, v in p.items()})
    jp = JParams(**{n: None if v is None else jnp.asarray(v) for n, v in p.items()})
    return x, tp, jp


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_kernel_f32(case):
    k, stride, expand, residual, band = case
    x, tp, jp = _both(k, expand)
    kw = dict(kernel=k, stride=stride, residual=residual, band_rows=band)
    got = tk.banded_mbconv_infer(torch.from_numpy(x), tp, **kw).numpy()
    want = np.asarray(jk.banded_mbconv_infer(jnp.asarray(x), jp, **kw))
    assert got.shape == want.shape == (2, 16 // stride, 24 // stride, 8)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)


def test_bf16_band_invariance_and_jax():
    """tests/test_banded_mbconv.py:64-85 on the port: two band sizes agree
    within bf16 noise, and the port tracks the JAX kernel in bf16."""
    x, tp, jp = _both(3, True, seed=3, hw=(32, 16), batch=1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    outs = [tk.banded_mbconv_infer(xb, tp, kernel=3, stride=1, residual=True,
                                   band_rows=b).float().numpy() for b in (8, 32)]
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-2, atol=2e-2)
    want = np.asarray(jk.banded_mbconv_infer(
        jnp.asarray(x).astype(jnp.bfloat16), jp, kernel=3, stride=1, residual=True,
        band_rows=8).astype(jnp.float32))
    assert np.abs(outs[0] - want).max() <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("case", CASES[:4])
def test_plain_matches_k2_plain(case):
    """K3 and K2 compute the same function at even sizes (K2's TF SAME pads
    (p-1, p) at stride 2, K3's rows 2r+1-p .. 2r+1+p are the same window)."""
    k, stride, expand, residual, band = case
    x, tp, _ = _both(k, expand, seed=5)
    kw = dict(kernel=k, stride=stride, residual=residual)
    got = tk.banded_mbconv_plain(torch.from_numpy(x), tp, band_rows=band, **kw)
    want = k2.mbconv_infer_plain(torch.from_numpy(x), tp, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-5, atol=3e-5)


def test_default_band_is_pick_band():
    assert [tk.pick_band(h) for h in (112, 56, 64, 7, 3)] == [28, 28, 32, 7, 3]
    x, tp, _ = _both(3, True, hw=(16, 8), batch=1)
    kw = dict(kernel=3, stride=1, residual=True)
    assert torch.equal(tk.banded_mbconv_infer(torch.from_numpy(x), tp, **kw),
                       tk.banded_mbconv_plain(torch.from_numpy(x), tp, band_rows=16, **kw))


def test_band_must_divide_output_height():
    x, tp, _ = _both(3, True, hw=(16, 8), batch=1)
    with pytest.raises(ValueError, match="must divide"):
        tk.banded_mbconv_infer(torch.from_numpy(x), tp, kernel=3, stride=1, residual=True,
                               band_rows=3)
    with pytest.raises(ValueError, match="must divide"):
        tk.banded_mbconv_infer(torch.from_numpy(x), tp, kernel=3, stride=2, residual=False,
                               band_rows=16)


@pytest.mark.parametrize("hw", [(15, 8), (16, 9)])
def test_odd_size_at_stride_2_raises(hw):
    """Ho = H // stride, as in JAX: an odd size at stride 2 raises rather
    than return K2's ceil shape."""
    x, tp, _ = _both(3, True, hw=hw, batch=1)
    with pytest.raises(ValueError, match="even"):
        tk.banded_mbconv_infer(torch.from_numpy(x), tp, kernel=3, stride=2, residual=False)


def test_cpu_tensor_takes_plain_version_without_counting():
    x, tp, _ = _both(5, True)
    kw = dict(kernel=5, stride=2, residual=False, band_rows=4)
    before = tk.banded_mbconv_infer.launches
    got = tk.banded_mbconv_infer(torch.from_numpy(x), tp, **kw)
    assert torch.equal(got, tk.banded_mbconv_plain(torch.from_numpy(x), tp, **kw))
    assert tk.banded_mbconv_infer.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("block", ["stage2_block0", "stage2_block1", "stage3_block0",
                                   "stage3_block1"])
def test_plan_k3_fits_and_covers_the_b0_blocks(block, dtype):
    """plan_k3 at the four B0 blocks K3 serves (448^2, batch 8) and every
    divisor band: the strips cover the output width, the chunk's window
    (h, and for bf16 the chunk's x rows and a weight group) fits one
    block's shared memory."""
    from pldepth_torch.models.efficientnet import EfficientNetEncoder
    from pldepth_torch.models.fused_infer import plan_encoder

    with torch.device("meta"):
        enc = EfficientNetEncoder("b0", torch.bfloat16)
    plan = next(p for p in plan_encoder(enc, (448, 448), torch.bfloat16) if p.name == block)
    h, w = plan.in_hw
    cin, cout = plan.params.we.shape[0], plan.params.wp.shape[-1]
    ho, k, s = h // plan.stride, plan.kernel, plan.stride
    for band in [b for b in range(1, ho + 1) if ho % b == 0]:
        kp3 = tk.plan_k3(w, cin, cout, kernel=k, stride=s, band=band, n_bands=ho // band,
                         batch=8, has_expand=True, dtype=dtype)
        wo = w // s
        assert kp3.n_strips * kp3.strip >= wo > (kp3.n_strips - 1) * kp3.strip
        win = (7 * s + k) * ((kp3.strip - 1) * s + k)
        if dtype == torch.bfloat16:
            assert kp3.kp == -(-cin // 16) * 16
            assert kp3.smem == 2 * ((win + 8) * 72 + win * (kp3.kp + 8) + kp3.kp * 72)
        else:
            assert kp3.smem == win * 32 * 4
        assert kp3.smem + 4096 <= 232_448

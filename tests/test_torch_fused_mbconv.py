"""K2, the fused inference MBConv: the port's plain version against the JAX
package's ``fused_mbconv_infer`` (the Pallas kernel in interpret mode) on
the five block variants of tests/test_fused_mbconv.py, from the same seeded
numpy inputs. f32 at rtol = atol = 3e-5; bf16 at max|d| <= 1e-2 max|ref|.
The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pldepth_torch.ops import fused_mbconv as tk
from pldepth_tpu.ops import fused_mbconv as jk

torch.set_num_threads(1)

CASES = [(3, 1, True, True), (3, 2, True, False), (5, 1, True, True),
         (5, 2, True, False), (3, 1, False, False)]


def _params(seed, cin, ce, cout, k, cse, expand=True):
    rng = np.random.default_rng(seed)
    f = lambda shape, s=0.2: (rng.normal(size=shape) * s).astype(np.float32)
    return dict(
        we=f((cin, ce)) if expand else None,
        e_scale=1.0 + f((ce,), 0.05) if expand else None,
        e_shift=f((ce,), 0.05) if expand else None,
        dw=f((k, k, ce)), d_scale=1.0 + f((ce,), 0.05), d_shift=f((ce,), 0.05),
        se_w1=f((ce, cse)), se_b1=f((cse,)), se_w2=f((cse, ce)), se_b2=f((ce,)),
        wp=f((ce, cout)), p_scale=1.0 + f((cout,), 0.05), p_shift=f((cout,), 0.05),
    )


def _both(case, seed=0, hw=(16, 12), batch=2):
    k, stride, expand, residual = case
    cin = cout = 8
    ce = cin * (6 if expand else 1)
    p = _params(seed + 1, cin, ce, cout, k, 4, expand)
    x = np.random.default_rng(seed).normal(size=(batch, *hw, cin)).astype(np.float32)
    tp = tk.MBConvParams(**{n: None if v is None else torch.from_numpy(v) for n, v in p.items()})
    jp = jk.MBConvParams(**{n: None if v is None else jnp.asarray(v) for n, v in p.items()})
    return x, tp, jp, dict(kernel=k, stride=stride, residual=residual)


@pytest.fixture(scope="module")
def jax_outputs():
    """The JAX kernel's outputs for every case and dtype, computed once."""
    out = {}
    for case in CASES:
        x, _, jp, kw = _both(case)
        for dt in (jnp.float32, jnp.bfloat16):
            y = jk.fused_mbconv_infer(jnp.asarray(x).astype(dt), jp, **kw)
            out[case, jnp.dtype(dt).name] = np.asarray(y.astype(jnp.float32))
    return out


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_kernel_f32(case, jax_outputs):
    x, tp, _, kw = _both(case)
    got = tk.fused_mbconv_infer(torch.from_numpy(x), tp, **kw).numpy()
    want = jax_outputs[case, "float32"]
    k, stride = kw["kernel"], kw["stride"]
    assert got.shape == want.shape == (2, 16 // stride, 12 // stride, 8)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_kernel_bf16(case, jax_outputs):
    x, tp, _, kw = _both(case)
    got = tk.fused_mbconv_infer(torch.from_numpy(x).to(torch.bfloat16), tp, **kw)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = jax_outputs[case, "bfloat16"]
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def test_odd_sizes_follow_tf_same():
    """Stride 2 on odd sizes: ceil output and TF SAME padding, as lax's
    SAME conv (the reference the kernel's halo arithmetic follows)."""
    import jax

    x, tp, _, kw = _both((5, 2, True, False), hw=(7, 9))
    got = tk.mbconv_infer_plain(torch.from_numpy(x), tp, **kw)
    assert got.shape == (2, 4, 5, 8)
    h = torch.einsum("bhwc,cd->bhwd", torch.from_numpy(x), tp.we)
    h = tk._swish(h * tp.e_scale + tp.e_shift)
    dwk = jnp.asarray(tp.dw.numpy()).reshape(5, 5, 1, -1)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(h.numpy()), dwk, (2, 2), "SAME", feature_group_count=h.shape[-1],
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    hn = torch.nn.functional.pad(h, (0, 0, *tk.same_pads(7, 9, 5, 2)))
    ours = torch.nn.functional.conv2d(
        hn.permute(0, 3, 1, 2), tp.dw.permute(2, 0, 1)[:, None], stride=2,
        groups=h.shape[-1]).permute(0, 2, 3, 1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), atol=1e-5)


def test_wrapper_checks_shapes():
    x, tp, _, kw = _both(CASES[0])
    with pytest.raises(ValueError, match="wp"):
        tk.fused_mbconv_infer(torch.from_numpy(x), tp._replace(wp=tp.wp[:5]), **kw)
    with pytest.raises(ValueError, match="residual"):
        tk.fused_mbconv_infer(torch.from_numpy(x), tp, kernel=3, stride=2, residual=True)
    with pytest.raises(TypeError):
        tk.fused_mbconv_infer(torch.from_numpy(x).double(), tp, **kw)


def test_cpu_tensor_takes_plain_version_without_counting():
    x, tp, _, kw = _both(CASES[2])
    before = tk.fused_mbconv_infer.launches
    got = tk.fused_mbconv_infer(torch.from_numpy(x), tp, **kw)
    want = tk.mbconv_infer_plain(torch.from_numpy(x), tp, **kw)
    assert torch.equal(got, want)
    assert tk.fused_mbconv_infer.launches == before

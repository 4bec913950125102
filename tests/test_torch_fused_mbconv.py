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


# The tile planner (plan_k2) at every block shape the encoders give K2: its
# shared memory fits a block, its grid covers every output pixel and
# channel, and its channel groups tile Ce. Meta-device encoders: shapes only.
VARIANTS = [("smoke", 64)] + [(f"b{i}", 448) for i in range(8)]


def _k2_shapes(variant, size):
    from pldepth_torch.models.efficientnet import EfficientNetEncoder
    from pldepth_torch.models.fused_infer import plan_encoder

    with torch.device("meta"):
        enc = EfficientNetEncoder(variant, torch.bfloat16)
    shapes = []
    for plan in plan_encoder(enc, (size, size), torch.bfloat16):
        p, tap = plan.params, plan.tap is not None
        expand = p.we is not None and not tap  # a tap block's K2 call has no expand
        cin = p.we.shape[0] if expand else p.dw.shape[-1]
        shapes.append((plan.name, *plan.in_hw, cin, p.dw.shape[-1], p.wp.shape[-1],
                       plan.kernel, plan.stride, expand))
    return shapes


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("variant,size", VARIANTS)
def test_plan_k2_fits_and_covers_every_block(variant, size, dtype):
    shapes = _k2_shapes(variant, size)
    assert len(shapes) >= 7 and any(not s[-1] for s in shapes)  # tap forms included
    for name, h, w, cin, ce, cout, k, s, expand in shapes:
        assert cin % 8 == 0 and ce % 8 == 0 and cout % 8 == 0, name
        plan = tk.plan_k2(h, w, cin, ce, cout, kernel=k, stride=s, batch=8,
                          has_expand=expand, dtype=dtype)
        ho, wo = -(-h // s), -(-w // s)
        # every output pixel in exactly one tile, no empty tile
        assert plan.tiles_h * plan.th >= ho > (plan.tiles_h - 1) * plan.th, name
        assert plan.tiles_w * plan.tw >= wo > (plan.tiles_w - 1) * plan.tw, name
        # the channel groups tile Ce, the wide groups tile the groups
        width = tk.CG if dtype == torch.bfloat16 else tk.F32_SLICE
        assert plan.groups * width >= ce > (plan.groups - 1) * width, name
        assert plan.wide * plan.gpb >= plan.groups > (plan.wide - 1) * plan.gpb, name
        # the shared memory the kernel lays out, within one block's
        ih, iw = (plan.th - 1) * s + k, (plan.tw - 1) * s + k
        if dtype == torch.bfloat16:
            assert plan.kp == (-(-cin // 16) * 16 if expand else 0), name
            window = 2 * (ih * iw * (plan.kp + 8) + plan.kp * tk.HS) if expand else 0
            want = 2 * (ih * iw + tk.DW_PAD) * tk.HS + window
            assert plan.smem == want and plan.smem + tk.STATIC_SMEM <= 232_448, name
            assert plan.proj_mt in (1, 2)
        else:
            assert plan.smem == ih * iw * 32 * 4 <= 232_448 - 4096, name


def test_plan_k2_reads_the_window_once_per_wide_group():
    """B0 at 448^2, batch 8: blocks take their 64-channel groups in wide
    groups, so the Ce = 1152 blocks read each tile's window at most 9 times
    (a quarter of the 36 reads of 32-channel slices); a plan is a pure,
    memoised function."""
    for name, h, w, cin, ce, cout, k, s, expand in _k2_shapes("b0", 448):
        plan = tk.plan_k2(h, w, cin, ce, cout, kernel=k, stride=s, batch=8,
                          has_expand=expand, dtype=torch.bfloat16)
        assert plan.wide <= 18 and plan.wide <= -(-ce // 32), name
        if ce == 1152:
            assert plan.wide <= 9, (name, plan)
        assert tk.plan_k2(h, w, cin, ce, cout, kernel=k, stride=s, batch=8,
                          has_expand=expand, dtype=torch.bfloat16) is plan

"""Card-only tests of the port (``cuda`` marker; skipped without a card).

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`` (tests/conftest.py imports JAX). K2 is held
against its plain version at small, odd shapes: f32 at max|d| <= 1e-4
max|ref| (TF32 off), bf16 at 2e-2 (one bf16 rounding of g or of the scale
may land on the other side). K1 (forward and backward) is held against its
plain version and run through autograd and one train step; the fused K1
(the whole ranking loss and its gradient map) against ``ranking_loss_plain``
with collisions and out-of-range indices, one launch each way per loss and
gradient, and a CUDA context that stays usable after a bad index."""

import numpy as np
import pytest
import torch

from pldepth_torch.ops import fused_mbconv as k2

CASES = [(3, 1, True, True), (3, 2, True, False), (5, 1, True, True),
         (5, 2, True, False), (3, 1, False, False), (5, 2, False, False)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(case, hw, batch, cin, seed=0, cout=None):
    k, stride, expand, residual = case
    ce = cin * (6 if expand else 1)
    cout, cse = cout or cin, max(1, cin // 4)
    rng = np.random.default_rng(seed)
    f = lambda shape, s=0.2: torch.from_numpy((rng.normal(size=shape) * s).astype(np.float32))
    p = k2.MBConvParams(
        we=f((cin, ce)) if expand else None,
        e_scale=1.0 + f((ce,), 0.05) if expand else None,
        e_shift=f((ce,), 0.05) if expand else None,
        dw=f((k, k, ce)), d_scale=1.0 + f((ce,), 0.05), d_shift=f((ce,), 0.05),
        se_w1=f((ce, cse)), se_b1=f((cse,)), se_w2=f((cse, ce)), se_b2=f((ce,)),
        wp=f((ce, cout)), p_scale=1.0 + f((cout,), 0.05), p_shift=f((cout,), 0.05),
    )
    x = f((batch, *hw, cin), 1.0)
    return x, p, dict(kernel=k, stride=stride, residual=residual)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,cin", [((33, 30), 8), ((14, 14), 40)])
def test_kernel_matches_plain(case, dtype, hw, cin, cuda_device):
    x, p, kw = _case(case, hw, 3, cin)
    xd = x.to(cuda_device, dtype)
    pd = k2.cast_params(k2.MBConvParams(*[None if v is None else v.to(cuda_device) for v in p]), dtype)
    before = k2.fused_mbconv_infer.launches
    got = k2.fused_mbconv_infer(xd, pd, **kw).float()
    torch.cuda.synchronize()
    assert k2.fused_mbconv_infer.launches == before + 1
    want = k2.mbconv_infer_plain(xd, pd, **kw).float()
    assert got.shape == want.shape
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= tol, rel


# K2 at ragged shapes: the expand's K tail (Cin 24 / 40 / 112, no multiple
# of 16), Ce no multiple of the 64-channel group (144, 240, 672), odd sizes at
# stride 2, whole-image tiles, the tap form, and a B0 stage-1 block at 224^2
# (the 128-pixel project tile); bf16 within 1e-2, f32 within 1e-4
K2_RAGGED = [((3, 2, True, False), (33, 31), 24, None), ((5, 2, True, False), (29, 35), 40, None),
             ((5, 1, True, True), (14, 14), 112, None), ((3, 1, True, True), (28, 28), 112, None),
             ((5, 2, False, False), (15, 17), 40, None), ((3, 1, False, False), (224, 224), 32, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,hw,cin,cout", K2_RAGGED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_at_ragged_shapes(case, hw, cin, cout, dtype, cuda_device):
    x, p, kw = _case(case, hw, 2, cin, seed=4, cout=cout)
    xd = x.to(cuda_device, dtype)
    pd = k2.cast_params(k2.MBConvParams(*[None if v is None else v.to(cuda_device) for v in p]),
                        dtype)
    got = k2.fused_mbconv_infer(xd, pd, **kw).float()
    torch.cuda.synchronize()
    want = k2.mbconv_infer_plain(xd, pd, **kw).float()
    assert got.shape == want.shape
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= (1e-4 if dtype == torch.float32 else 1e-2), rel


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    x, p, kw = _case(CASES[0], (8, 8), 1, 8)
    pd = k2.MBConvParams(*[None if v is None else v.to(cuda_device) for v in p])
    xd = x.to(cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        k2.fused_mbconv_infer(xd.transpose(1, 2), pd, **kw)
    with pytest.raises(ValueError, match="is on cpu"):
        k2.fused_mbconv_infer(xd, p, **kw)
    # bf16 rows are whole 16-byte chunks: 12 channels are not
    x, p, kw = _case(CASES[1], (8, 8), 1, 12)
    pd = k2.cast_params(k2.MBConvParams(*[None if v is None else v.to(cuda_device) for v in p]),
                        torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        k2.fused_mbconv_infer(x.to(cuda_device, torch.bfloat16), pd, **kw)


# K3, the banded MBConv: kernel against its plain version (the band
# algorithm) at every divisor band of a small shape, and against K2 on the
# same inputs; the tolerances are K2's, and in bf16 K3 equals K2 bit for bit.
K3_CASES = [(3, 1, True, True), (3, 2, True, False), (5, 1, True, True),
            (5, 2, True, False), (3, 1, False, False), (5, 2, False, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K3_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_matches_plain_at_every_band(case, dtype, cuda_device):
    from pldepth_torch.ops import banded_mbconv as k3

    x, p, kw = _case(case, (24, 34), 2, 40 if case[2] else 24)
    xd = x.to(cuda_device, dtype)
    pd = k2.cast_params(k2.MBConvParams(*[None if v is None else v.to(cuda_device) for v in p]),
                        dtype)
    ho = 24 // kw["stride"]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    k2_out = k2.fused_mbconv_infer(xd, pd, **kw).float()
    for band in [b for b in range(1, ho + 1) if ho % b == 0]:
        before = k3.banded_mbconv_infer.launches
        got = k3.banded_mbconv_infer(xd, pd, band_rows=band, **kw).float()
        torch.cuda.synchronize()
        assert k3.banded_mbconv_infer.launches == before + 1
        want = k3.banded_mbconv_plain(xd, pd, band_rows=band, **kw).float()
        assert got.shape == want.shape == k2_out.shape
        for ref in (want, k2_out):
            rel = float((got - ref).abs().max() / ref.abs().max())
            assert rel <= tol, (band, rel)
        if dtype == torch.bfloat16:  # K2's expand, depthwise and project code
            assert torch.equal(got, k2_out), band


@pytest.mark.cuda
def test_k3_has_no_fallback(cuda_device, monkeypatch):
    """A CUDA tensor launches K3 or raises: never the plain version, and
    bad operands raise instead of taking another path."""
    from pldepth_torch.ops import banded_mbconv as k3

    x, p, kw = _case(CASES[0], (8, 8), 1, 8)
    pd = k2.MBConvParams(*[None if v is None else v.to(cuda_device) for v in p])
    xd = x.to(cuda_device)
    monkeypatch.setattr(k3, "banded_mbconv_plain",
                        lambda *a, **k: (_ for _ in ()).throw(AssertionError("plain")))
    assert k3.banded_mbconv_infer(xd, pd, **kw).is_cuda
    with pytest.raises(ValueError, match="contiguous"):
        k3.banded_mbconv_infer(xd.transpose(1, 2), pd, **kw)
    with pytest.raises(ValueError, match="is on cpu"):
        k3.banded_mbconv_infer(xd, p, **kw)
    with pytest.raises(ValueError, match="must divide"):
        k3.banded_mbconv_infer(xd, pd, band_rows=3, **kw)


@pytest.mark.cuda
def test_predict_fused_on_the_card_matches_predict(cuda_device):
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.train import Trainer

    for dt, tol in (("float32", 2e-4), ("bfloat16", 0.03)):
        cfg = ExperimentConfig(model_name="ff_smoke", input_size=64, compute_dtype=dt)
        trainer = Trainer(cfg)
        state = trainer.init_state()
        imgs = np.random.default_rng(1).uniform(size=(2, 64, 64, 3)).astype(np.float32)
        before = k2.fused_mbconv_infer.launches
        a = trainer.predict(state, imgs).float()
        b = trainer.predict_fused(state, imgs).float()
        assert k2.fused_mbconv_infer.launches - before == len(state.model.encoder.block_names)
        assert float((a - b).abs().max() / a.abs().max()) <= tol


# K1, the sorted ListMLE NLL: kernel against its plain version in f32, and
# autograd through ListMLESorted on the card. The same recurrences run in
# another order, and exp(s + P) - 1 cancels where a term is ~1, so the bound
# is chip_smoke.py's: max|d| <= 1e-5 + 3e-5 * max|ref| per output.
K1_CASES = [(1, 3), (257, 5), (3200, 5), (130, 25), (257, 128), (40, 500)]


def _k1_close(got, want):
    err, ref = float((got - want).abs().max()), float(want.abs().max())
    assert err <= 1e-5 + 3e-5 * ref, (err, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", K1_CASES)
def test_k1_matches_plain(n, k, cuda_device):
    from pldepth_torch.ops import listmle_kernel as k1

    rng = np.random.default_rng(k)
    s = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32) * 3).to(cuda_device)
    g = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)).to(cuda_device)
    before = (k1.listmle_fwd.launches, k1.listmle_bwd.launches)
    nll, lse = k1.listmle_fwd(s)
    ds = k1.listmle_bwd(s, lse, g)
    torch.cuda.synchronize()
    assert (k1.listmle_fwd.launches, k1.listmle_bwd.launches) == (before[0] + 1, before[1] + 1)
    want_nll, want_lse = k1.listmle_fwd_plain(s)
    _k1_close(nll, want_nll)
    _k1_close(lse, want_lse)
    _k1_close(ds, k1.listmle_bwd_plain(s, want_lse, g))


@pytest.mark.cuda
def test_k1_spread_and_empty(cuda_device):
    from pldepth_torch.ops import listmle_kernel as k1

    s = torch.tensor([[0.0, -50.0, -120.0], [5.0, -100.0, -230.0]], device=cuda_device)
    nll, lse = k1.listmle_fwd(s)
    ds = k1.listmle_bwd(s, lse, torch.ones(2, device=cuda_device))
    assert float(nll.abs().max()) < 1e-6 and float(ds.abs().max()) < 1e-4
    empty_nll, _ = k1.listmle_fwd(torch.zeros((0, 5), device=cuda_device))
    assert empty_nll.shape == (0,)


@pytest.mark.cuda
def test_k1_autograd_and_auto_impl_on_the_card(cuda_device, monkeypatch):
    """impl="auto" on a CUDA tensor runs K1 forward and backward, never the
    plain versions."""
    from pldepth_torch.ops import listmle_kernel as k1
    from pldepth_torch.ops.listmle import listmle_nll

    rng = np.random.default_rng(0)
    scores = torch.from_numpy(rng.normal(size=(300, 5)).astype(np.float32))
    labels = torch.from_numpy(rng.permuted(np.tile(np.arange(5, dtype=np.float32), (300, 1)),
                                           axis=1))
    ref = scores.clone().requires_grad_(True)
    listmle_nll(ref, labels).sum().backward()  # CPU: the plain path

    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(k1, "listmle_fwd_plain", refuse)
    monkeypatch.setattr(k1, "listmle_bwd_plain", refuse)
    sd = scores.to(cuda_device).requires_grad_(True)
    before = (k1.listmle_fwd.launches, k1.listmle_bwd.launches)
    nll = listmle_nll(sd, labels.to(cuda_device), impl="auto")
    nll.sum().backward()
    torch.cuda.synchronize()
    assert (k1.listmle_fwd.launches, k1.listmle_bwd.launches) == (before[0] + 1, before[1] + 1)
    _k1_close(sd.grad.cpu(), ref.grad)


@pytest.mark.cuda
def test_train_step_on_the_card_runs_k1(cuda_device):
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.data.datasets import SyntheticDepthDataset
    from pldepth_torch.ops import listmle_kernel as k1
    from pldepth_torch.train import Trainer

    cfg = ExperimentConfig(model_name="ff_smoke", input_size=64, batch_size=2,
                           ranking_size=5, rankings_per_image=20, freeze_encoder=True)
    trainer = Trainer(cfg)
    state = trainer.init_state()
    ds = SyntheticDepthDataset(4, 64, 0)
    batch = {k: np.stack([ds[i][k] for i in range(2)]) for k in ("image", "gt", "mask")}
    before = (k1.ranking_loss_fwd.launches, k1.ranking_loss_bwd.launches)
    state, m = trainer.train_step(state, batch)
    assert bool(m.finite) and np.isfinite(float(m.loss))
    assert (k1.ranking_loss_fwd.launches, k1.ranking_loss_bwd.launches) == (
        before[0] + 1, before[1] + 1)


# The fused K1 (gather, label sort, NLL, mean; the gradient map by atomics)
# against ranking_loss_plain on 448^2 maps: per-list NLL and loss, and the
# map for a cotangent of N (entries O(1)), within chip_smoke.py's bound;
# pixels shared by several lists are summed in the atomics' order. NaN
# exactly where the plain version is NaN.
FUSED_CASES = [(3200, 5), (400, 5), (12800, 10), (257, 500)]


def _fused_case(n, k, device, size=448, seed=0):
    """(map (B, size^2), rankings (B, N / B, K, 2)): depths rounded to
    1/255, half the lists on a pool of 16 pixels (collisions), every 7th
    list with an index from -1, -size^2 - 1, size^2, NaN."""
    rng = np.random.default_rng(seed + n + k)
    b = 4 if n == 400 else int(np.gcd(n, 32))
    p = size * size
    pred = rng.normal(size=(b, p)).astype(np.float32) * 3
    idx = rng.integers(0, p, size=(n, k)).astype(np.float32)
    idx[1::2] = rng.integers(0, p, size=16)[rng.integers(0, 16, size=idx[1::2].shape)]
    bad = np.array([-1, -p - 1, p, np.nan], np.float32)
    idx[::7, rng.integers(0, k)] = bad[np.arange(len(idx[::7])) % 4]
    labels = np.round(rng.uniform(0.05, 1.0, (n, k)) * 255) / 255
    rk = np.stack([idx, labels], -1).reshape(b, n // b, k, 2).astype(np.float32)
    return torch.from_numpy(pred).to(device), torch.from_numpy(rk).to(device)


def _nan_close(got, want):
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = ~torch.isnan(want)
    if bool(fin.any()):
        _k1_close(got[fin], want[fin])


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", FUSED_CASES)
def test_fused_k1_matches_plain(n, k, cuda_device):
    from pldepth_torch.ops import listmle_kernel as k1

    pred, rk = _fused_case(n, k, cuda_device)
    g = torch.tensor(float(n), device=cuda_device)
    before = (k1.ranking_loss_fwd.launches, k1.ranking_loss_bwd.launches)
    loss, nll, lse, sidx = k1.ranking_loss_fwd(pred, rk)
    grad = k1.ranking_loss_bwd(pred, lse, sidx, g)
    torch.cuda.synchronize()
    assert (k1.ranking_loss_fwd.launches, k1.ranking_loss_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ref = pred.clone().requires_grad_(True)
    want_nll = k1.ranking_nll_plain(ref, rk)
    (want_grad,) = torch.autograd.grad(want_nll.mean(), ref, g)
    _, _, want_lse, want_sidx = k1.ranking_loss_fwd_plain(pred, rk)
    assert torch.equal(sidx, want_sidx)
    assert bool(torch.isnan(want_nll).any()) and bool(torch.isfinite(want_nll).any())
    _nan_close(nll, want_nll.detach())
    _nan_close(loss, want_nll.detach().mean())
    _nan_close(lse, want_lse)
    _nan_close(grad, want_grad)
    # without faults the loss is finite and agrees too
    clean = rk.clone()
    clean[..., 0] = torch.where(torch.isnan(clean[..., 0]) | (clean[..., 0] < 0) |
                                (clean[..., 0] >= pred.shape[1]), 0.0, clean[..., 0])
    loss = k1.ranking_loss_fwd(pred, clean, residuals=False)[0]
    want = k1.ranking_loss_plain(pred, clean)
    assert bool(torch.isfinite(loss))
    _k1_close(loss, want)


@pytest.mark.cuda
def test_fused_k1_launches_once_each_way(cuda_device, monkeypatch):
    """pl_ranking_loss + backward on the card: one fused forward and one
    fused backward launch, never a plain version; eval (no grad) saves no
    residuals."""
    from pldepth_torch.ops import listmle_kernel as k1
    from pldepth_torch.ops.listmle import pl_ranking_loss

    pred, rk = _fused_case(400, 5, cuda_device, size=64)
    ref = pred.cpu().reshape(4, 64, 64, 1).requires_grad_(True)
    pl_ranking_loss(ref, rk.cpu()).backward()

    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("ranking_loss_plain", "ranking_loss_fwd_plain", "ranking_loss_bwd_plain"):
        monkeypatch.setattr(k1, name, refuse)
    p = pred.reshape(4, 64, 64, 1).clone().requires_grad_(True)
    before = (k1.ranking_loss_fwd.launches, k1.ranking_loss_bwd.launches)
    pl_ranking_loss(p, rk).backward()
    torch.cuda.synchronize()
    assert (k1.ranking_loss_fwd.launches, k1.ranking_loss_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    _nan_close(p.grad.cpu() * 400, ref.grad * 400)
    with torch.no_grad():
        loss = pl_ranking_loss(p, rk)
    assert loss.grad_fn is None and loss.shape == ()
    assert (k1.ranking_loss_fwd.launches, k1.ranking_loss_bwd.launches) == (
        before[0] + 2, before[1] + 1)


@pytest.mark.cuda
def test_fused_k1_out_of_range_index_keeps_the_context(cuda_device):
    """An index outside the map gives a NaN loss (F4), never a device-side
    assert: the context runs later work."""
    from pldepth_torch.ops.listmle import pl_ranking_loss

    pred = torch.randn(1, 4, 4, 1, device=cuda_device, requires_grad=True)
    rk = torch.rand(1, 3, 5, 2, device=cuda_device)
    rk[..., 0] = torch.randint(0, 16, (1, 3, 5), device=cuda_device).float()
    rk[0, 0, 1, 0], rk[0, 1, 2, 0] = -1.0, 19.0
    loss = pl_ranking_loss(pred, rk)
    loss.backward()
    torch.cuda.synchronize()
    ref = pred.detach().cpu().requires_grad_(True)
    pl_ranking_loss(ref, rk.cpu()).backward()
    assert bool(torch.isnan(loss)) and bool(torch.isnan(pred.grad).any())
    assert torch.equal(torch.isnan(pred.grad.cpu()), torch.isnan(ref.grad))
    x = torch.arange(10.0, device=cuda_device)
    assert float((x * 2).sum()) == 90.0


# K4, the int8 tensor-core matmul: kernel against its plain version (exact
# int32 sums in both; f32 out at rtol = atol = 1e-5, tests/test_quantize.py:135's
# bound, and bit-equal without swish; bf16 out within one bf16 ulp), every
# act, ragged M / N / K, K of 8- and 1-byte loader widths.
K4_CASES = [(96, 256, 136, None), (128, 512, 64, "swish"), (997, 27, 5, None),
            (1000, 250, 37, "swish"), (129, 70, 70, "relu"), (65, 4, 33, None),
            (3, 1, 1, "relu"), (6272, 480, 112, None), (1568, 11520, 672, "relu"),
            (4100, 24, 144, None), (4100, 40, 240, "relu"), (300, 144, 24, None),
            (70000, 16, 96, None), (5000, 80, 16, "swish")]
# the window read in place: (batch, H, W, Cin, Cout, window, stride, padding,
# act); odd and even sizes at stride 2, Cin 3 / 24 / 40, the 7x7 pad-3 stem,
# 1x1 stride 2, odd Cout, a window larger than the image's rows
K4_WINDOWS = [(2, 57, 43, 3, 16, 3, 2, None, "swish"), (2, 56, 44, 3, 32, 3, 2, None, None),
              (2, 56, 44, 24, 40, 3, 2, None, "relu"), (2, 33, 31, 40, 24, 3, 1, None, None),
              (2, 33, 31, 64, 48, 1, 2, None, None), (2, 34, 32, 64, 48, 1, 2, None, "relu"),
              (2, 45, 51, 3, 64, 7, 2, 3, "relu"), (2, 44, 52, 3, 64, 7, 2, 3, None),
              (3, 15, 17, 128, 37, 7, 2, 3, None), (1, 5, 5, 16, 8, 3, 1, None, None),
              (4, 28, 28, 288, 144, 3, 1, None, None), (1, 2, 3, 8, 8, 7, 1, None, None),
              (2, 9, 11, 3, 24, 1, 1, None, None), (2, 19, 18, 5, 40, 3, 2, None, "relu"),
              (2, 30, 30, 96, 72, 3, 1, None, "swish"), (1, 14, 14, 512, 520, 3, 1, None, None)]


def _k4_operands(m, k, n, device, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return (t(rng.integers(-127, 128, (m, k), dtype=np.int8)),
            t(rng.integers(-127, 128, (k, n), dtype=np.int8)),
            t((rng.random(n) * 0.01 + 1e-3).astype(np.float32)),
            t((rng.standard_normal(n) * 0.1).astype(np.float32)), 0.05 / k ** 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,act", K4_CASES)
def test_k4_matches_plain(m, k, n, act, cuda_device):
    from pldepth_torch.ops import quant_matmul as k4

    ops = _k4_operands(m, k, n, cuda_device)
    before = k4.quant_matmul.launches
    got = k4.quant_matmul(*ops, act=act, out_dtype=torch.float32)
    gotb = k4.quant_matmul(*ops, act=act).float()
    torch.cuda.synchronize()
    assert k4.quant_matmul.launches == before + 2
    want = k4.quant_matmul_plain(*ops, act=act, out_dtype=torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    wantb = k4.quant_matmul_plain(*ops, act=act).float()
    ulp = torch.exp2(torch.floor(torch.log2(wantb.abs().clamp_min(1e-30))) - 7)
    assert bool(((gotb - wantb).abs() <= ulp).all())
    # the exact int32 sums: unit scales, no bias, f32 out (|acc| < 2^24 here)
    x, w = ops[0], ops[1]
    ones, zeros = torch.ones(n, device=cuda_device), torch.zeros(n, device=cuda_device)
    acc = k4.quant_matmul(x, w, ones, zeros, 1.0, out_dtype=torch.float32)
    ref = (x.cpu().to(torch.int64) @ w.cpu().to(torch.int64)).to(torch.float32)
    assert torch.equal(acc.cpu(), ref)
    if act != "swish":
        assert torch.equal(got, want)
    # a kept pack gives the same bytes as packing on the fly
    kept = k4.quant_matmul(*ops, act=act, out_dtype=torch.float32, w_packed=k4.pack_weight(w))
    assert torch.equal(kept, got)


@pytest.mark.cuda
@pytest.mark.parametrize("case", K4_WINDOWS)
def test_k4_window_read_matches_im2col_plus_plain(case, cuda_device):
    from pldepth_torch.ops import quant_conv as qc
    from pldepth_torch.ops import quant_matmul as k4

    b, h, w, cin, cout, k, stride, padding, act = case
    rng = np.random.default_rng(h * w + cin)
    t = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    q = t(rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8))
    kq = t(rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8))
    ws = t((rng.random(cout) * 0.01 + 1e-3).astype(np.float32))
    bias = t((rng.standard_normal(cout) * 0.1).astype(np.float32))
    a = 0.05 / (k * k * cin) ** 0.5
    before = (k4.quant_matmul.launches, qc.quant_conv2d.window_launches, qc.im2col_same.calls)
    got = qc.quant_conv2d(q, kq, ws, bias, a, stride, torch.float32, padding, act)
    gotb = qc.quant_conv2d(q, kq, ws, bias, a, stride, torch.bfloat16, padding, act,
                           w_packed=qc.pack_kernel(kq)).float()
    torch.cuda.synchronize()
    assert (k4.quant_matmul.launches, qc.quant_conv2d.window_launches,
            qc.im2col_same.calls) == (before[0] + 2, before[1] + 2, before[2])
    want = qc.quant_conv2d_plain(q, kq, ws, bias, a, stride, torch.float32, padding, act)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if act != "swish":
        assert torch.equal(got, want)
    wantb = qc.quant_conv2d_plain(q, kq, ws, bias, a, stride, torch.bfloat16, padding,
                                  act).float()
    ulp = torch.exp2(torch.floor(torch.log2(wantb.abs().clamp_min(1e-30))) - 7)
    assert bool(((gotb - wantb).abs() <= ulp).all())
    # the exact int32 sums against the CPU's int64 product of the patch matrix
    ones, zeros = torch.ones(cout, device=cuda_device), torch.zeros(cout, device=cuda_device)
    acc = qc.quant_conv2d(q, kq, ones, zeros, 1.0, stride, torch.float32, padding)
    ref = qc.im2col_same(q.cpu(), k, stride, padding).to(torch.int64) @ \
        kq.cpu().reshape(-1, cout).to(torch.int64)
    assert torch.equal(acc.cpu().reshape(-1, cout), ref.to(torch.float32))


@pytest.mark.cuda
def test_k4_rejects_and_empty(cuda_device):
    from pldepth_torch.ops import quant_matmul as k4

    x, w, ws, b, a = _k4_operands(64, 32, 16, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        k4.quant_matmul(x.t().contiguous().t(), w, ws, b, a)
    with pytest.raises(ValueError, match="is on cpu"):
        k4.quant_matmul(x, w.cpu(), ws, b, a)
    with pytest.raises(TypeError, match="int8"):
        k4.quant_matmul(x.float(), w, ws, b, a)
    with pytest.raises(ValueError, match="pack_weight"):
        k4.quant_matmul(x, w, ws, b, a, w_packed=w.t().contiguous())
    empty = k4.quant_matmul(x[:0], w, ws, b, a)
    assert empty.shape == (0, 16)


@pytest.mark.cuda
def test_k4_on_the_card_never_reaches_the_plain_route(cuda_device, monkeypatch):
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.ops import quant_conv as qc
    from pldepth_torch.ops import quant_matmul as k4
    from pldepth_torch.train import Trainer

    trainer = Trainer(ExperimentConfig(model_name="ff_smoke", input_size=64))
    imgs = np.random.default_rng(1).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    qstate = trainer.prepare_quant(trainer.init_state(), imgs)

    def refuse(*args, **kwargs):
        raise AssertionError("the card's route reached the plain version")

    monkeypatch.setattr(qc, "im2col_same", refuse)
    monkeypatch.setattr(qc, "quant_conv2d_plain", refuse)
    monkeypatch.setattr(k4, "quant_matmul_plain", refuse)
    x, w, ws, b, a = _k4_operands(64, 32, 16, cuda_device)
    k4.quant_matmul(x, w, ws, b, a)
    q = x.reshape(1, 8, 8, 32)
    qc.quant_conv2d(q, w.reshape(1, 1, 32, 16), ws, b, a, stride=2)
    qc.quant_conv2d(q, torch.zeros(3, 3, 32, 16, dtype=torch.int8, device=cuda_device), ws, b, a)
    assert torch.isfinite(trainer.predict_quant(qstate, imgs).float()).all()
    # and a pack on another device than the activation raises, it does not fall back
    with pytest.raises(ValueError, match="is on cpu"):
        qc.quant_conv2d(q, w.reshape(1, 1, 32, 16), ws, b, a, stride=2,
                        w_packed=qc.pack_kernel(w.reshape(1, 1, 32, 16).cpu()))


@pytest.mark.cuda
def test_int8_serving_on_the_card_runs_k4_at_every_dense_site(cuda_device):
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.models.quantize import quant_sites
    from pldepth_torch.ops import quant_matmul as k4
    from pldepth_torch.train import Trainer

    cfg = ExperimentConfig(model_name="ff_smoke", input_size=64)
    trainer = Trainer(cfg)
    state = trainer.init_state()
    imgs = np.random.default_rng(1).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    qstate = trainer.prepare_quant(state, imgs)
    dense = sum(m.groups == 1 for m in quant_sites(qstate.model).values())
    from pldepth_torch.ops import quant_conv as qc

    sites = [m for m in quant_sites(qstate.model).values() if m.groups == 1]
    windows = sum(m.kernel_q.shape[0] > 1 or m.stride > 1 for m in sites)
    before = (k4.quant_matmul.launches, qc.quant_conv2d.window_launches, qc.im2col_same.calls)
    q = trainer.predict_quant(qstate, imgs).float()
    assert k4.quant_matmul.launches - before[0] == dense
    assert qc.quant_conv2d.window_launches - before[1] == windows > 0
    assert qc.im2col_same.calls == before[2]  # no patch matrix on the card
    b = trainer.predict_bnfold(state, imgs).float()
    assert torch.isfinite(q).all()
    rel = float((q - b).abs().max() / b.abs().max())
    r = float(np.corrcoef(q.cpu().numpy().ravel(), b.cpu().numpy().ravel())[0, 1])
    assert rel < 0.15 and r > 0.98, (rel, r)


# -- evaluation: device metrics, the device report, nearest resize --------------
@pytest.mark.cuda
@pytest.mark.parametrize("tau", [0.0, 0.03])
@pytest.mark.parametrize("invert", [False, True])
def test_device_metrics_on_the_card_equal_the_cpu(tau, invert, cuda_device):
    from pldepth_torch.eval import device_metrics as D

    rng = np.random.default_rng(0)
    gt = rng.uniform(0.05, 1, (3, 4096)).astype(np.float32)
    pred = (0.7 * gt + 0.3 * rng.uniform(size=gt.shape)).astype(np.float32)
    gt[:, 0], gt[:, 1] = np.float32(1.03), np.float32(1.0)  # a pair on the band's edge
    idx = np.stack([rng.choice(4096, 1000, replace=False) for _ in range(3)])
    idx[:, 0], idx[:, 500] = 0, 1
    cpu = [torch.from_numpy(a) for a in (pred, gt, idx[:, :500], idx[:, 500:])]
    dev = [a.to(cuda_device) for a in cpu]
    got = D.pairwise_disagreement(*dev, tau, invert)
    assert got.is_cuda and got.cpu().tolist() == D.pairwise_disagreement(*cpu, tau, invert).tolist()
    nd = D.ndcg_sampled(dev[0], dev[1], dev[2]).cpu()
    torch.testing.assert_close(nd, D.ndcg_sampled(cpu[0], cpu[1], cpu[2]), rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_full_report_device_keeps_the_maps_on_the_card(cuda_device, monkeypatch):
    """The device report reads trainer.predict (never the host-copying
    serving callable) and brings three scalars per image to the host."""
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.data.datasets import SyntheticDepthDataset
    from pldepth_torch.eval import Evaluator
    from pldepth_torch.train import Trainer

    trainer = Trainer(ExperimentConfig(model_name="ff_smoke", input_size=64))
    ev = Evaluator(trainer, trainer.init_state(), eval_batch_size=4)
    ds = SyntheticDepthDataset(6, 64, seed=3)  # 6: the last batch is padded
    host = ev.full_report(ds)

    def no_serving(*a, **k):
        raise AssertionError("the device report used the host-copying serving callable")

    ev._predict = no_serving
    moved = []
    real_cpu = torch.Tensor.cpu

    def spy_cpu(t, *a, **k):
        if t.is_cuda:
            moved.append(t.numel())
        return real_cpu(t, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", spy_cpu)
    dev = ev.full_report_device(ds)
    monkeypatch.undo()
    assert moved == [3 * 4, 3 * 4]  # one (3, batch) copy per batch, no map
    for key, tol in (("test_error", 0.03), ("whdr_tau_0.03", 0.03), ("ndcg_200", 0.05)):
        assert abs(dev[key] - host[key]) <= tol, (key, dev, host)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,size,channel_last", [
    ((7, 5), (3, 4), True), ((9, 6, 3), (20, 13), True), ((2, 9, 6, 3), (5, 7), True),
    ((3, 9, 6), (19, 14), False)])
def test_resize_nearest_on_the_card_equals_the_cpu(shape, size, channel_last, cuda_device):
    from pldepth_torch.ops.resize import resize_nearest

    x = torch.from_numpy(np.random.default_rng(0).uniform(size=shape).astype(np.float32))
    got = resize_nearest(x.to(cuda_device), size, channel_last=channel_last)
    assert got.is_cuda and torch.equal(got.cpu(), resize_nearest(x, size, channel_last=channel_last))


# -- export and the training options on the card ---------------------------------
def _step_batch(size=64, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(size=(batch, size, size, 3)).astype(np.float32),
            "gt": rng.uniform(0.1, 1.0, size=(batch, size, size)).astype(np.float32),
            "mask": np.ones((batch, size, size), np.float32)}


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [2, 0])
def test_artifact_on_the_card_equals_predict_bnfold(batch, cuda_device, tmp_path):
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.serve.export import export_predict, load_exported
    from pldepth_torch.train import Trainer

    trainer = Trainer(ExperimentConfig(model_name="ff_smoke", input_size=64,
                                       compute_dtype="float32"))
    state = trainer.init_state()
    path = str(tmp_path / "m.plx")
    export_predict(trainer, state, batch, path, bn_fold=True)
    call, meta = load_exported(path)
    imgs = _step_batch(batch=3)["image"]
    n = batch or 3
    got = call(imgs[:n])
    assert got.is_cuda and got.shape == (n, 64, 64)
    want = trainer.predict_bnfold(state, imgs[:n])
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    cpu_call, _ = load_exported(path, "cpu")
    assert not cpu_call(imgs[:n]).is_cuda


@pytest.mark.cuda
def test_qenc_int8_step_runs_k4_at_every_dense_encoder_site(cuda_device):
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.models.quantize import QuantConv, quant_sites
    from pldepth_torch.ops import listmle_kernel as k1
    from pldepth_torch.ops import quant_matmul as k4
    from pldepth_torch.train import Trainer

    cfg = ExperimentConfig(model_name="ff_smoke", input_size=64, batch_size=2,
                           freeze_encoder=True, qenc="int8")
    trainer = Trainer(cfg, steps_per_epoch=4)
    state = trainer.init_state()
    batch = _step_batch()
    with pytest.raises(RuntimeError, match="prepare_qenc"):
        trainer.train_step(state, batch)
    trainer.prepare_qenc(state, batch["image"])
    enc = trainer._qenc[1]
    dense = sum(m.groups == 1 for m in quant_sites(enc).values())
    enc0 = {k: v.clone() for k, v in state.model.encoder.state_dict().items()}
    builds, fwd = QuantConv.derivations, k1.ranking_loss_fwd.launches
    before = k4.quant_matmul.launches
    for _ in range(3):
        state, m = trainer.train_step(state, batch)
        assert bool(m.finite)
    torch.cuda.synchronize()
    # the first step eagerly, then replays, which count the captured launches
    assert (trainer.graph_captures, trainer.graph_replays) == (1, 2)
    assert k4.quant_matmul.launches - before == 3 * dense > 0
    assert QuantConv.derivations - builds == len(quant_sites(enc))  # packed once
    assert k1.ranking_loss_fwd.launches - fwd == 3
    for k, v in state.model.encoder.state_dict().items():
        assert torch.equal(v, enc0[k]), k


@pytest.mark.cuda
def test_sparse_tail_step_runs_the_sorted_k1(cuda_device):
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.ops import listmle_kernel as k1
    from pldepth_torch.train import Trainer

    cfg = ExperimentConfig(model_name="ff_smoke", input_size=64, batch_size=2,
                           rankings_per_image=16, ranking_size=5, sparse_tail=True)
    trainer = Trainer(cfg, steps_per_epoch=4)
    state = trainer.init_state()
    names = ("listmle_fwd", "listmle_bwd", "ranking_loss_fwd", "ranking_loss_bwd")
    before = {n: getattr(k1, n).launches for n in names}
    for _ in range(2):
        state, m = trainer.train_step(state, _step_batch())
        assert bool(m.finite)
    torch.cuda.synchronize()
    got = {n: getattr(k1, n).launches - before[n] for n in names}
    assert got == {"listmle_fwd": 2, "listmle_bwd": 2, "ranking_loss_fwd": 0,
                   "ranking_loss_bwd": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("hw,split,p", [((64, 64), 8, 0.1), ((67, 53), 4, 0.05),
                                        ((448, 448), 32, 0.08)])
def test_tile_hausdorff_batch_on_the_card_equals_the_cpu(hw, split, p, cuda_device):
    """Distances and witnesses bit for bit, ties to the first index (integer
    offsets tie often), with an empty map in the batch; at 448^2 / split 32
    the chunk bound splits the batch of 8 (157 MB an image)."""
    from pldepth_torch.active import acquisition as acq

    rng = np.random.default_rng(5)
    n = 8 if hw[0] == 448 else 3
    a = (rng.uniform(size=(n, *hw)) < p).astype(np.uint8) * 255
    b = (rng.uniform(size=(n, *hw)) < p).astype(np.uint8) * 255
    a[0] = 0
    b[1, : hw[0] // 2] = 0
    want = acq.tile_hausdorff_batch(a, b, split, "cpu")
    got = acq.tile_hausdorff_batch(a, b, split)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if hw[0] == 448:
        np.testing.assert_array_equal(got[0][2], acq.tile_hausdorff(a[2], b[2], split)[0])


@pytest.mark.cuda
def test_jit_predict_resident_on_the_card_equals_predict(cuda_device):
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.data.datasets import SyntheticDepthDataset
    from pldepth_torch.data.resident import build_resident_store
    from pldepth_torch.train import Trainer

    trainer = Trainer(ExperimentConfig(model_name="ff_smoke", input_size=64,
                                       compute_dtype="float32"))
    state = trainer.init_state()
    store = build_resident_store(SyntheticDepthDataset(6, 64, seed=2))
    u8 = store.arrays["image"]
    fn = trainer.jit_predict_resident(4)
    for start in (0, 2):
        # the CPU's true division, the one the card's tensor division gives
        x = (u8[start: start + 4].cpu().to(torch.float32) / 255.0).cuda()
        got = np.asarray(fn(state, u8, start))
        np.testing.assert_array_equal(got, trainer.predict(state, x).cpu().numpy())


def _chip_smoke():
    """chip_smoke.py as a module: its trace parser names the kernels."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_profile_trace_of_a_card_step_holds_the_fused_k1(cuda_device, tmp_path):
    """obs/profiling.py's trace of one train step records K1's fused
    forward and backward kernels (template MODE 1, the whole loss), once
    each, beside the rest of the step."""
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.obs.profiling import profile_trace
    from pldepth_torch.train import Trainer

    trainer = Trainer(ExperimentConfig(model_name="ff_smoke", input_size=64, batch_size=2,
                                       rankings_per_image=16, ranking_size=5))
    state = trainer.init_state()
    state, _ = trainer.train_step(state, _step_batch())
    torch.cuda.synchronize()
    with profile_trace(str(tmp_path)):
        for _ in range(8):  # the first launches of a window can go unrecorded
            torch.cuda._sleep(1000)
        trainer.train_step(state, _step_batch())
    smoke = _chip_smoke()
    kernels, _, _ = smoke.trace_kernels(str(tmp_path))
    k1 = {n: c for n, c in kernels.items() if n.startswith("k1_")}
    assert k1 == {"k1_fwd_thread_kernel<5, 1>": 1, "k1_bwd_thread_kernel<5, 1>": 1}, k1
    assert smoke.k1_trace_counts(kernels) == {"ranking_loss_fwd": 1, "ranking_loss_bwd": 1,
                                              "listmle_fwd": 0, "listmle_bwd": 0}
    assert sum(kernels.values()) > 20


@pytest.mark.cuda
def test_a_span_holds_its_launch_and_kernel_on_the_card_trace(cuda_device, tmp_path):
    """obs/spans.py stamps on the card trace's clock: a span around one
    launch of ``torch.cuda._sleep`` and a sync holds that launch and its
    kernel, matched by the trace's correlation id. (The launch's ``tid``
    is CUPTI's thread id, not the native id the span and the host ops
    carry, so a launch is matched to spans by time.)"""
    import json

    from torch.profiler import ProfilerActivity, profile

    from pldepth_torch.obs import spans

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(8):  # the first launches of a window can go unrecorded
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        with spans.recording() as rec:
            with spans.span("sleep"):
                torch.cuda._sleep(100_000)
                torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    (s,) = rec.spans

    def inside(e):
        t0 = base + round(e["ts"] * 1e3)
        return s.start_ns <= t0 and t0 + round(e.get("dur", 0) * 1e3) <= s.end_ns

    kernels = [e for e in events if e.get("cat") == "kernel" and inside(e)]
    assert len(kernels) == 1, [e["name"] for e in kernels]
    corr = kernels[0]["args"]["correlation"]
    launch = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and (e.get("args") or {}).get("correlation") == corr]
    assert len(launch) == 1 and inside(launch[0]), launch


@pytest.mark.cuda
def test_two_ranks_on_the_card_match_the_single_process_step(cuda_device):
    """chip_smoke.py phase 18b at the smoke size: two ranks share the card
    over gloo (each a child process with torchrun's variables), 4 rows a
    rank of ff_smoke at 64^2 (f32, frozen encoder, info_score, K 5),
    against the single-process batch-8 steps on the same rows: the step-1
    loss, the first all-reduced flat gradient and the new BN running
    statistics within phase 18's bounds, the ranks' states bit-equal, K1
    one fused forward and backward a rank a step."""
    import os
    import sys
    import tempfile

    from pldepth_torch.train import Trainer

    smoke = _chip_smoke()
    ref = smoke.dp_steps(Trainer(smoke.dp_smoke_config(smoke.DP_SMOKE_BATCH), smoke.DP_STEPS),
                         smoke.dp_batches(smoke.DP_SMOKE_BATCH, smoke.DP_SMOKE_SIZE,
                                          smoke.DP_STEPS))
    with tempfile.TemporaryDirectory() as out:
        smoke.spawn_ranks([sys.executable, smoke.__file__, "--dp_child", "18b-smoke",
                           "--dp_out", out], 2, 2, "18b-smoke", timeout=300)
        ranks = [torch.load(os.path.join(out, f"18b-smoke_r{r}.pt"), weights_only=False)
                 for r in range(2)]
    for rank in ranks:
        assert rank["backend"] == "gloo"
        gaps = smoke.dp_gaps(rank, ref)
        assert all(gaps[k] <= smoke.DP_TOL[k] for k in smoke.DP_TOL), gaps
        assert rank["k1"] == {"ranking_loss_fwd": smoke.DP_STEPS,
                              "ranking_loss_bwd": smoke.DP_STEPS}
    for k, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 4])
def test_sharded_conv_on_the_card_equals_the_unsharded_conv(m, cuda_device):
    """ops/conv.py's row-sharded conv (and ops/resize.py's upsample and
    ops/fused_tail.py's tail) on CUDA tensors: each rank's rows, cut from
    the whole f32 tensor with its halo, equal the unsharded op on the card
    within 1e-5 of its largest value (cuDNN may convolve other row counts
    with another algorithm); B0's 448^2 partition over ``m`` ranks, 3 x 3
    and 5 x 5 at stride 1 and 2."""
    from pldepth_torch.ops import conv, fused_tail, halo, resize

    heights = halo.level_heights(448, 5)
    parts = halo.row_partition(heights, m)
    gen = torch.Generator(device="cuda").manual_seed(m)

    def close(got, want):
        assert got.shape == want.shape
        if want.numel():
            assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())

    for lvl, k, stride in ((0, 3, 2), (2, 5, 1), (3, 5, 2), (5, 3, 1)):
        x = torch.randn(2, heights[lvl], heights[lvl], 8, device="cuda", generator=gen)
        w = torch.randn(8, 1, k, k, device="cuda", generator=gen)
        full = conv.conv2d_same_nhwc(x, w, stride, groups=8)
        for q in range(m):
            plan = conv.conv_row_plan(halo.RowShard(heights, parts, q, lvl), k, stride)
            got = conv.conv2d_rows_local(halo.extend_from_full(x, plan, q), w, stride, 8, None,
                                         plan, q)
            s, e = parts[lvl + stride - 1][q]
            close(got, full[:, s:e])
    x = torch.randn(2, heights[1], heights[1], 16, device="cuda", generator=gen)
    w, b = torch.randn(1, 16, 3, 3, device="cuda", generator=gen), torch.zeros(1, device="cuda")
    up, tail = resize.upsample2x_bilinear(x), fused_tail.fused_upsample2x_conv(x, w, b)
    for q in range(m):
        plan = resize.upsample_row_plan(halo.RowShard(heights, parts, q, 1))
        ext = halo.extend_from_full(x, plan, q)
        s, e = parts[0][q]
        close(resize.upsample2x_rows_local(ext, plan, q), up[:, s:e])
        close(fused_tail.fused_tail_rows_local(ext, w, b, plan, q), tail[:, s:e])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 4])
def test_k4_window_on_row_extended_int8_equals_its_plain_twin(m, cuda_device):
    """ops/quant_conv.py's row-local int8 conv on the card (K4's window
    entry point, row pad 0 after zero rows outside the image, the image's
    column pad) against its plain twin on the same extended rows, f32 out
    bit-equal, and against the unsharded plain conv's rows; one window
    read a rank that owns output rows, none on a rank that owns none (B0's
    448^2 partition over ``m`` ranks: at 4 the deepest rows split 4/4/4/2):
    the stem (3 x 3 stride 2, 3 channels), a 3 x 3 at stride 1, ResNet's
    1 x 1 stride 2 and its 7 x 7 stride-2 stem padded by 3."""
    from pldepth_torch.ops import conv, halo, quant_conv

    heights = halo.level_heights(448, 5)
    parts = halo.row_partition(heights, m)
    gen = torch.Generator(device="cuda").manual_seed(m)
    for lvl, k, stride, cin, padding in ((0, 3, 2, 3, None), (2, 3, 1, 24, None),
                                         (2, 1, 2, 64, None), (0, 7, 2, 3, 3), (5, 3, 1, 40, None)):
        cout = 16
        q8 = torch.randint(-127, 128, (2, heights[lvl], 36, cin), dtype=torch.int8, device="cuda",
                           generator=gen)
        kq = torch.randint(-127, 128, (k, k, cin, cout), dtype=torch.int8, device="cuda",
                           generator=gen)
        ws = torch.rand(cout, device="cuda", generator=gen) * 1e-3
        bias = torch.randn(cout, device="cuda", generator=gen)
        whole = quant_conv.quant_conv2d_plain(q8, kq, ws, bias, 0.02, stride, torch.float32,
                                              padding)
        for q in range(m):
            plan = conv.conv_row_plan(halo.RowShard(heights, parts, q, lvl), k, stride, padding)
            ext = halo.extend_from_full(q8, plan, q).contiguous()
            args = (kq, ws, bias, 0.02, stride, torch.float32, padding, plan, q)
            before = quant_conv.quant_conv2d.window_launches
            got = quant_conv.quant_conv2d_rows_local(ext, *args)
            torch.cuda.synchronize()
            s, e = parts[lvl + stride - 1][q]
            assert quant_conv.quant_conv2d.window_launches - before == int(e > s)
            assert torch.equal(got, quant_conv.quant_conv2d_rows_local_plain(ext, *args))
            assert torch.equal(got, whole[:, s:e])


@pytest.mark.cuda
def test_qenc_int8_sharded_step_launches_k4_on_every_rank(cuda_device):
    """chip_smoke.py phase 20's qenc int8 case at the smoke size: two ranks
    share the card over gloo (child processes with torchrun's variables),
    ff_smoke 64^2 at data 1 x model 2 (each rank owns rows at every level)
    after ``prepare_qenc`` on the whole images: each rank launches K4 once
    a step at every dense int8 encoder site, the stem through the window
    read on its extended rows, and the fused K1 once each way a step; the
    ranks' states bit-equal."""
    import os
    import sys
    import tempfile

    smoke = _chip_smoke()
    with tempfile.TemporaryDirectory() as out:
        smoke.spawn_ranks([sys.executable, smoke.__file__, "--dp_child", "20-smoke",
                           "--dp_out", out], 2, 2, "20-smoke", timeout=300)
        ranks = [torch.load(os.path.join(out, f"20-smoke_r{r}.pt"), weights_only=False)
                 for r in range(2)]
    n = smoke.SP_STEPS
    for rank in ranks:
        sites, counts = rank["sites"], rank["counts"]
        assert sites["dense"] > sites["windows"] == 1
        assert counts["quant_matmul"] == n * sites["dense"]
        assert counts["window_reads"] == n * sites["windows"]
        assert (counts["ranking_loss_fwd"], counts["ranking_loss_bwd"]) == (n, n)
        assert rank["k4_site"]["equal_plain"] and rank["k4_site"]["equal_whole"]
    assert ranks[0]["digest"] == ranks[1]["digest"]


@pytest.mark.cuda
def test_fit_profile_on_the_card_holds_its_waits_and_kernels(cuda_device, tmp_path):
    """``fit(profile_dir=)`` on the card: steps 1-3 in the trace, each
    with a ``fit.wait`` on the step before, and the kernels of each step
    launched inside one of its phases (by correlation id): step 0, before
    the trace, is the step graph's warm-up and capture, steps 1-3 replays,
    whose kernels the graph's launch in ``step.replay`` issues."""
    import json

    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.data.datasets import SyntheticDepthDataset
    from pldepth_torch.data.pipeline import BatchIterator
    from pldepth_torch.train import Trainer

    cfg = ExperimentConfig(model_name="ff_smoke", input_size=64, batch_size=2,
                           ranking_size=5, rankings_per_image=20, freeze_encoder=True)
    trainer = Trainer(cfg, steps_per_epoch=5)
    it = BatchIterator(SyntheticDepthDataset(16, 64, 0), 2, seed=0)
    state, _ = trainer.fit(trainer.init_state(), it, epochs=1, profile_dir=str(tmp_path))
    it.close()
    assert state.step == 5
    (path,) = tmp_path.glob("*.pt.trace.json")
    trace = json.loads(path.read_text())
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    assert [e["args"]["ident"] for e in spans if e["name"] == "step"] == [1, 2, 3]
    # the wait after queueing step s is on step s - 1
    assert [e["args"]["ident"] for e in spans if e["name"] == "fit.wait"] == [0, 1, 2]
    phases = [e for e in spans if e["name"] in ("step.upload", "step.sample", "step.forward",
                                                "step.backward", "step.update", "step.replay")]
    assert [e["args"]["ident"] for e in spans if e["name"] == "step.replay"] == [1, 2, 3]
    launches = {(e.get("args") or {}).get("correlation"): e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")}
    steps = [e for e in spans if e["name"] == "step"]

    def launch(k):
        return launches.get(k["args"].get("correlation"))

    # the kernels the three steps launched, on any thread
    kernels = [k for k in events if k.get("cat") == "kernel" and launch(k) is not None
               and steps[0]["ts"] <= launch(k)["ts"] <= steps[-1]["ts"] + steps[-1]["dur"]]
    assert kernels

    def launched_in(k):
        return any(p["ts"] <= launch(k)["ts"] <= p["ts"] + p["dur"] for p in phases)

    # a replay's kernels are launched inside step.replay
    assert sum(map(launched_in, kernels)) >= 0.9 * len(kernels)


# The one-card step graph (train/trainer.py): a replayed step computes the
# eager step, for both model families on both feeds and for each option
# the graph takes; fit captures once and replays every later step; a step
# makes no host sync; a profiler window opened after the capture still
# names the replayed kernels.
GRAPH_CASES = [("ff_effnet", "host", {}), ("ff_effnet", "resident", {}),
               ("ff_redweb", "host", {}), ("ff_redweb", "resident", {}),
               ("ff_effnet", "host", {"grad_accum": 2}),
               ("ff_effnet", "resident", {"sparse_tail": True}),
               ("ff_effnet", "host", {"qenc": "bf16"}), ("ff_effnet", "host", {"qenc": "int8"}),
               ("ff_effnet", "host", {"qres": "int8"})]


def _graph_config(model, **opts):
    from pldepth_torch.core.config import ExperimentConfig

    return ExperimentConfig(model_name=model, input_size=64, batch_size=2, ranking_size=5,
                            rankings_per_image=20, freeze_encoder=True, **opts)


def _state_tensors(state):
    """The state's tensors themselves, the optimizer's fields included
    (its ``state_dict()`` would copy them)."""
    out = {f"param.{n}": p for n, p in state.model.named_parameters()}
    out.update({f"buffer.{n}": b for n, b in state.model.named_buffers()})
    out.update({f"opt.{k}": v for k, v in vars(state.opt).items()
                if isinstance(v, torch.Tensor)})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("model,feed,opts", GRAPH_CASES)
def test_graphed_steps_equal_eager_steps(model, feed, opts, cuda_device):
    """Six steps, graphed and eager in lockstep (f32, TF32 off): before
    each step the eager trainer takes the graphed one's state. Equal bit
    for bit: what the forward decides, the loss, the finite flag, every BN
    running statistic and the optimizer's counters. The backward's atomic
    adds (the bilinear upsample's and K1's) sum in an order no two eager
    runs share either, so the moments are held within 1e-5 of their
    largest element, and the parameters' change within 1e-2 of the LR
    wherever the gradient is above 1e-3 of its largest (AMSGrad moves a
    parameter by about the LR in the sign of its gradient: a gradient
    within rounding of 0, as of a conv bias under a batch-statistics BN,
    takes either sign)."""
    from pldepth_torch.data.datasets import SyntheticDepthDataset
    from pldepth_torch.data.resident import build_resident_store
    from pldepth_torch.train import Trainer
    from pldepth_torch.train.trainer import trainable_params

    cfg = _graph_config(model, compute_dtype="float32", **opts)
    batches = [_step_batch(seed=i) for i in range(6)]
    store = build_resident_store(SyntheticDepthDataset(8, 64, 0), cuda_device) \
        if feed == "resident" else None
    graphed, eager = Trainer(cfg, steps_per_epoch=8), Trainer(cfg, steps_per_epoch=8)
    eager._graphed = lambda: False
    sg, se = graphed.init_state(), eager.init_state()
    if cfg.qenc == "int8":
        for tr, st in ((graphed, sg), (eager, se)):
            tr.prepare_qenc(st, batches[0]["image"])

    def step(tr, st, i):
        return (tr.resident_step(st, store.arrays) if store is not None
                else tr.train_step(st, batches[i]))

    def flat(st):
        return torch.cat([p.detach().reshape(-1) for p in trainable_params(st.model)])

    for i in range(6):
        with torch.no_grad():
            tg = _state_tensors(sg)
            for k, v in _state_tensors(se).items():
                v.copy_(tg[k])
        se = se.replace(step=sg.step)
        before = flat(sg)
        sg, mg = step(graphed, sg, i)
        se, me = step(eager, se, i)
        torch.cuda.synchronize()
        assert torch.equal(mg.loss, me.loss) and torch.equal(mg.finite, me.finite), (
            i, float(mg.loss), float(me.loss))
        assert bool(mg.finite)
        tg, te = _state_tensors(sg), _state_tensors(se)
        for k, v in te.items():
            if k.startswith("buffer.") or not v.is_floating_point():
                assert torch.equal(tg[k], v), (i, k)
            elif k.startswith("opt."):
                assert float((tg[k] - v).abs().max()) <= 1e-5 * float(v.abs().max()), (i, k)
        mu = se.opt.mu  # (1 - b1) g after the first update
        sure = mu.abs() > 1e-3 * float(mu.abs().max())
        lr = float(me.lr)
        gap = ((flat(sg) - before) - (flat(se) - before))[sure].abs()
        assert float(gap.max()) <= 1e-2 * lr if gap.numel() else True, (i, float(gap.max()), lr)
    assert (graphed.graph_captures, graphed.graph_replays) == (1, 5)
    assert (eager.graph_captures, eager.graph_replays) == (0, 0)


@pytest.mark.cuda
def test_fit_captures_once_and_replays_every_later_step(cuda_device):
    from pldepth_torch.data.datasets import SyntheticDepthDataset
    from pldepth_torch.data.pipeline import BatchIterator
    from pldepth_torch.train import Trainer

    trainer = Trainer(_graph_config("ff_effnet"), steps_per_epoch=6)
    it = BatchIterator(SyntheticDepthDataset(16, 64, 0), 2, seed=0)
    try:
        state, _ = trainer.fit(trainer.init_state(), it, epochs=1)
        # the first step eagerly as the warm-up, then the capture; every
        # later step a replay
        assert (trainer.graph_captures, trainer.graph_replays) == (1, 5)
        state, _ = trainer.fit(state, it, epochs=2)  # the same state: the same graph
        assert (state.step, trainer.graph_captures, trainer.graph_replays) == (12, 1, 11)
        trainer.fit(trainer.init_state(), it, epochs=1)  # new tensors: a new capture
        assert (trainer.graph_captures, trainer.graph_replays) == (2, 16)
    finally:
        it.close()


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["ff_effnet", "ff_redweb"])
def test_a_card_step_makes_no_host_sync(model, cuda_device):
    """Past the first step (which makes the device constants), an eager
    step and the replays make no host sync: nothing in the step waits for
    the stream, so the step can be captured and the host runs ahead."""
    from pldepth_torch.train import Trainer

    trainer = Trainer(_graph_config(model), steps_per_epoch=8)
    state = trainer.init_state()
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in _step_batch().items()}
    state, _ = trainer.train_step(state, batch)  # the warm-up and the capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = trainer._eager_step(state, batch)
        for _ in range(2):
            state, _ = trainer.train_step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert (trainer.graph_captures, trainer.graph_replays) == (1, 2)


@pytest.mark.cuda
def test_a_profiler_window_after_the_capture_names_the_replayed_kernels(cuda_device,
                                                                        tmp_path):
    """The benchmark's traced window opens after the capture: each
    replayed step's kernels are still in the trace by name, K1's fused
    forward and backward once a step, beside the rest of the step."""
    from torch.profiler import ProfilerActivity, profile

    from pldepth_torch.train import Trainer

    trainer = Trainer(_graph_config("ff_effnet"), steps_per_epoch=8)
    state = trainer.init_state()
    for i in range(2):
        state, _ = trainer.train_step(state, _step_batch(seed=i))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(8):  # the first launches of a window can go unrecorded
            torch.cuda._sleep(1000)
        for i in range(2):
            state, _ = trainer.train_step(state, _step_batch(seed=2 + i))
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "x.pt.trace.json"))
    assert (trainer.graph_captures, trainer.graph_replays) == (1, 3)
    kernels, device_ms, _ = _chip_smoke().trace_kernels(str(tmp_path))
    k1 = {n: c for n, c in kernels.items() if n.startswith("k1_")}
    assert k1 == {"k1_fwd_thread_kernel<5, 1>": 2, "k1_bwd_thread_kernel<5, 1>": 2}, k1
    assert sum(kernels.values()) > 100 and device_ms > 0

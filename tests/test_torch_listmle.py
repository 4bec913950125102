"""K1 (the sorted ListMLE NLL) and the port's loss stack against the JAX
package on the CPU.

On the CPU the K1 wrappers run their plain versions (reverse
``torch.logcumsumexp`` forward, the closed-form prefix backward), the
arithmetic the CUDA kernels implement. They are held against JAX
``listmle_sorted`` (the Pallas kernel in interpret mode) at K in {3, 5, 25,
128}, N in {1, 130}, and against ``impl="xla"`` at K=500: forward rel
<= 1e-5 (atol 1e-6), gradients atol <= 1e-5. The spread > 87 list and the
TF-reference loss golden (rtol 1e-5, as tests/test_full_parity.py) too.
The whole loss (``ranking_loss_plain``: gather by the rule of
``jnp.take_along_axis``, label sort, NLL, mean) and its gradient map are
held against JAX ``pl_ranking_loss`` (``impl="xla"``, and ``"pallas"`` in
interpret mode) at K in {1, 3, 5, 10, 25, 128, 500} with ties, NaN labels,
repeated pixels and the spread > 87 list: loss rtol 1e-6, map atol 1e-6
plus 2e-6 of each entry (entries reach (j + 1) / N at list position j).
The fused kernels' wrappers (``RankingLoss``) on the CPU are the plain
versions. Inputs are made by numpy from a seed and handed to both
packages."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pldepth_torch.core.device import resolve_impl
from pldepth_torch.ops import listmle_kernel as k1
from pldepth_torch.ops.listmle import (
    gather_ranked_scores,
    listmle_nll,
    listmle_sorted_plain,
    pl_ranking_loss,
    pl_ranking_loss_from_scores,
)
from pldepth_tpu.ops.listmle import listmle_nll as j_listmle_nll
from pldepth_tpu.ops.listmle import pl_ranking_loss as j_pl_ranking_loss
from pldepth_tpu.ops.listmle_pallas import listmle_sorted as j_listmle_sorted

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "listmle_reference.npz")


def _scores(n, k, seed=0):
    return np.random.default_rng(seed).normal(size=(n, k)).astype(np.float32)


def _port_fwd_bwd(s, g):
    """nll and ds through the autograd Function (K1's CPU path)."""
    st = torch.from_numpy(s).requires_grad_(True)
    nll = k1.ListMLESorted.apply(st)
    nll.backward(torch.from_numpy(g))
    return nll.detach().numpy(), st.grad.numpy()


def _jax_fwd_bwd(fn, s, g):
    nll, vjp = jax.vjp(fn, jnp.asarray(s))
    return np.asarray(nll), np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("k", [3, 5, 25, 128])
@pytest.mark.parametrize("n", [1, 130])
def test_k1_plain_matches_jax_kernel(n, k):
    s = _scores(n, k, seed=k)
    g = np.random.default_rng(1).uniform(0.5, 1.5, n).astype(np.float32)
    nll, ds = _port_fwd_bwd(s, g)
    want_nll, want_ds = _jax_fwd_bwd(j_listmle_sorted, s, g)
    np.testing.assert_allclose(nll, want_nll, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ds, want_ds, rtol=0, atol=1e-5)


def test_k1_plain_matches_jax_xla_at_k500():
    n, k = 40, 500
    s = _scores(n, k, seed=5)
    labels = np.tile(np.arange(k, 0, -1, dtype=np.float32), (n, 1))  # already sorted
    g = np.ones(n, np.float32)
    nll, ds = _port_fwd_bwd(s, g)
    want_nll, want_ds = _jax_fwd_bwd(
        lambda x: j_listmle_nll(x, jnp.asarray(labels), impl="xla"), s, g)
    np.testing.assert_allclose(nll, want_nll, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ds, want_ds, rtol=0, atol=1e-5)


def test_k1_spread_beyond_f32_exp_range_stays_exact():
    """A list whose scores spread by more than ~87 (tests/test_listmle.py):
    the true NLL is ~2e-22 and the gradient of a perfectly ordered list
    ~0; a single-global-max form reports 34.8."""
    s = np.array([[0.0, -50.0, -120.0], [5.0, -100.0, -230.0]], np.float32)
    nll, ds = _port_fwd_bwd(s, np.ones(2, np.float32))
    want_nll, want_ds = _jax_fwd_bwd(j_listmle_sorted, s, np.ones(2, np.float32))
    np.testing.assert_allclose(nll, want_nll, rtol=1e-5, atol=1e-6)
    assert np.abs(nll).max() < 1e-6 and np.abs(ds).max() < 1e-4
    np.testing.assert_allclose(ds, want_ds, rtol=0, atol=1e-5)


def test_k1_wrappers_on_the_cpu_are_the_plain_versions():
    s = torch.from_numpy(_scores(7, 4))
    before = (k1.listmle_fwd.launches, k1.listmle_bwd.launches)
    nll, lse = k1.listmle_fwd(s)
    torch.testing.assert_close(nll, listmle_sorted_plain(s), rtol=0, atol=0)
    ds = k1.listmle_bwd(s, lse, torch.ones(7))
    torch.testing.assert_close(ds, k1.listmle_bwd_plain(s, lse, torch.ones(7)), rtol=0, atol=0)
    assert (k1.listmle_fwd.launches, k1.listmle_bwd.launches) == before  # no kernel ran
    empty = k1.listmle_fwd(torch.zeros((0, 5)))
    assert empty[0].shape == (0,) and empty[1].shape == (0, 5)
    with pytest.raises(TypeError, match="float32"):
        k1.listmle_fwd(s.double())
    with pytest.raises(ValueError, match=r"\(N, K\)"):
        k1.listmle_fwd(torch.zeros(5))


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_listmle_nll_sorts_by_label_like_jax(impl):
    n, k = 33, 6
    rng = np.random.default_rng(2)
    s = rng.normal(size=(n, k)).astype(np.float32)
    labels = rng.permuted(np.tile(np.arange(k, dtype=np.float32), (n, 1)), axis=1)
    got = listmle_nll(torch.from_numpy(s), torch.from_numpy(labels), impl=impl).numpy()
    want = np.asarray(j_listmle_nll(jnp.asarray(s), jnp.asarray(labels), impl="xla"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_resolve_impl():
    assert resolve_impl("auto", "cpu") == "xla"
    assert resolve_impl("auto", torch.device("cuda")) == "pallas"
    assert resolve_impl("xla", torch.device("cuda")) == "xla"
    assert resolve_impl("pallas", "cuda") == "pallas"
    with pytest.raises(RuntimeError, match="no cpu mode"):
        resolve_impl("pallas", "cpu")
    with pytest.raises(ValueError, match="unknown impl"):
        resolve_impl("triton", "cpu")


def test_loss_matches_tf_reference_golden():
    data = np.load(GOLDEN)
    rankings = torch.from_numpy(data["rankings"])
    logits = torch.from_numpy(data["logits"])
    scores = gather_ranked_scores(logits[..., 0], rankings[..., 0].long())
    k = rankings.shape[-2]
    nll = listmle_nll(scores, rankings[..., 1].reshape(-1, k)).numpy()
    np.testing.assert_allclose(nll, data["nll"], rtol=1e-5, atol=1e-6)
    loss = float(pl_ranking_loss(logits[..., 0], rankings))
    np.testing.assert_allclose(loss, float(data["loss"]), rtol=1e-5)
    from_scores = float(pl_ranking_loss_from_scores(scores.reshape(rankings.shape[0], -1), rankings))
    np.testing.assert_allclose(from_scores, float(data["loss"]), rtol=1e-5)


def test_pl_ranking_loss_and_map_gradient_match_jax():
    """Gather at flat x*W+y, sort, loss and the scatter-add gradient into
    the depth map, against the JAX loss on the same maps and rankings."""
    from pldepth_tpu.ops.listmle import pl_ranking_loss as j_loss

    rng = np.random.default_rng(3)
    b, h, w, rpi, k = 2, 8, 9, 6, 5
    pred = rng.normal(size=(b, h, w, 1)).astype(np.float32)
    idx = rng.integers(0, h * w, size=(b, rpi, k))
    depths = rng.uniform(0.1, 1.0, size=(b, rpi, k))
    rankings = np.stack([idx, depths], axis=-1).astype(np.float32)
    pt = torch.from_numpy(pred).requires_grad_(True)
    loss = pl_ranking_loss(pt, torch.from_numpy(rankings))
    loss.backward()
    jl, jg = jax.value_and_grad(lambda p: j_loss(p, jnp.asarray(rankings), impl="xla"))(
        jnp.asarray(pred))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(jg), rtol=0, atol=1e-6)


def _ranking_inputs(k, seed=0):
    """(pred (2, S, S, 1), rankings (2, 16, K, 2)), S = 32 / 64 / 128 as K
    grows (collisions stay the chosen ones): depths rounded to 1/255
    (ties), a NaN label in list 1 of each image, the first 8 positions of
    lists 2 and 3 on a pool of 5 pixels (repeats inside and across lists),
    and in list 0 the two lowest labels on pixels of their own scoring -50
    and -120 (its last suffix sits more than 87 below the list's max)."""
    rng = np.random.default_rng(100 + seed + k)
    b, rpi = 2, 16
    s = 32 if k <= 25 else 64 if k <= 128 else 128
    p = s * s
    pred = rng.normal(size=(b, p)).astype(np.float32) * 3
    idx = rng.integers(0, p - 2, size=(b, rpi, k)).astype(np.float32)
    pool = rng.integers(0, p - 2, size=5)
    m = min(k, 8)
    idx[:, 2:4, :m] = pool[rng.integers(0, 5, size=(b, 2, m))]
    labels = (np.round(rng.uniform(0.05, 1.0, (b, rpi, k)) * 255) / 255).astype(np.float32)
    labels[:, 1, rng.integers(0, k)] = np.nan
    if k >= 3:
        low = np.argsort(labels[0, 0])[:2]  # the lowest label last
        idx[0, 0, low] = [p - 1, p - 2]
        pred[0, p - 2:] = [-50.0, -120.0]
    return pred.reshape(b, s, s, 1), np.stack([idx, labels], -1).astype(np.float32)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("k", [1, 3, 5, 10, 25, 128, 500])
def test_ranking_loss_plain_matches_jax(k, impl):
    pred, rankings = _ranking_inputs(k)
    pt = torch.from_numpy(pred).requires_grad_(True)
    loss = k1.ranking_loss_plain(pt, torch.from_numpy(rankings))
    loss.backward()
    jl, jg = jax.value_and_grad(
        lambda p: j_pl_ranking_loss(p, jnp.asarray(rankings), impl=impl))(jnp.asarray(pred))
    jg = np.asarray(jg)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    np.testing.assert_array_equal(np.isnan(pt.grad.numpy()), np.isnan(jg))
    # an entry at list position j reaches (j + 1) / N (15 here at K = 500),
    # where one f32 ulp is 1e-6: atol 1e-6 plus 2e-6 of the entry's size
    np.testing.assert_allclose(pt.grad.numpy(), jg, rtol=2e-6, atol=1e-6)


def test_ranking_loss_on_the_cpu_is_the_plain_version():
    pred, rankings = _ranking_inputs(5, seed=1)
    rk = torch.from_numpy(rankings)
    before = (k1.ranking_loss_fwd.launches, k1.ranking_loss_bwd.launches)
    ref = torch.from_numpy(pred).requires_grad_(True)
    want = k1.ranking_loss_plain(ref, rk)
    want.backward()
    pt = torch.from_numpy(pred).requires_grad_(True)
    got = k1.ranking_loss(pt, rk)
    assert got.grad_fn is not None and type(got.grad_fn).__name__ == "RankingLossBackward"
    got.backward()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    torch.testing.assert_close(pt.grad, ref.grad, rtol=0, atol=1e-7)
    flat = torch.from_numpy(pred).reshape(2, -1)
    loss, nll, lse, sidx = k1.ranking_loss_fwd(flat, rk)
    torch.testing.assert_close(nll, k1.ranking_nll_plain(flat, rk), rtol=0, atol=0)
    assert sidx.dtype == torch.int32 and lse.shape == sidx.shape == (32, 5)
    grad = k1.ranking_loss_bwd(flat, lse, sidx, torch.tensor(1.0))
    torch.testing.assert_close(grad, ref.grad.reshape(2, -1), rtol=0, atol=1e-7)
    assert k1.ranking_loss_fwd(flat, rk, residuals=False)[2:] == (None, None)
    with torch.no_grad():
        torch.testing.assert_close(k1.ranking_loss(pt, rk), want.detach(), rtol=1e-6, atol=0)
    assert (k1.ranking_loss_fwd.launches, k1.ranking_loss_bwd.launches) == before
    with pytest.raises(ValueError, match="RPI, K, 2"):
        k1.ranking_loss_fwd(flat, rk[..., :1])
    with pytest.raises(TypeError, match="float32"):
        k1.ranking_loss_fwd(flat.double(), rk)

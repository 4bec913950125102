"""Three places where the port once parted from the JAX package, each held
to the reference:

* F1: the scored samplers keep the top RPI lists in the order
  ``jax.lax.top_k`` gives, ties to the lower index, on a ground truth
  quantised to 1/255 (8-bit depth PNGs), where list scores tie;
* F2: ``predict_fused`` on a model without MBConv blocks (ff_redweb) serves
  ``predict``, as ``pldepth_tpu/train/trainer.py:predict_fused`` does;
* F3: an unreadable ``best_val.json`` resets best-val tracking with a
  warning, and a truncated weights npz gives ``infer_decoder_head_ch`` its
  default, as ``pldepth_tpu/train/checkpoint.py`` does;
* F4: a ranking index outside the map gathers as ``jnp.take_along_axis``
  does (a negative index wraps once, one still outside reads NaN and gets
  no gradient), so the loss is NaN and the trainer's finite guard refuses
  the step, where ``torch.gather`` raised.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pldepth_torch.core.config import ExperimentConfig
from pldepth_torch.ops import listmle_kernel as k1
from pldepth_torch.ops.listmle import pl_ranking_loss
from pldepth_torch.sampling import rank_candidates
from pldepth_torch.sampling.samplers import SAMPLERS, mask_to_gt_index
from pldepth_torch.train import Trainer
from pldepth_torch.train.checkpoint import (
    CheckpointManager,
    infer_decoder_head_ch,
    save_weights_npz,
)
from pldepth_tpu.ops.listmle import pl_ranking_loss as j_pl_ranking_loss
from pldepth_tpu.sampling import samplers as js

torch.set_num_threads(1)

SCORED = sorted(n for n in SAMPLERS if js.get_sampler(n).scored and n != "segment")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", SCORED)
def test_f1_quantised_depths_keep_the_jax_lists_in_order(name, seed):
    """The JAX sampler's candidates through the port's sort / score / keep
    on a gt rounded to 1/255: the same lists in the same order."""
    rng = np.random.default_rng(40 + seed)
    hg, wg = 24, 32
    gt = (np.round(rng.uniform(0.05, 1.0, (hg, wg)) * 255) / 255).astype(np.float32)
    mask = (rng.uniform(size=(hg, wg)) < 0.8).astype(np.float32)
    rpi, k = 40, 3
    spec = js.get_sampler(name)
    n_cand = max(int(rpi * spec.oversample_factor), rpi)
    key = jax.random.key(7 + seed)
    want = np.asarray(js.sample_rankings(
        key, jnp.asarray(gt), jnp.asarray(mask), sampler_name=name,
        rankings_per_image=rpi, ranking_size=k, threshold=0.03))
    midx = np.asarray(js._masked_uniform_points(key, jnp.asarray(mask.reshape(-1)), n_cand * k))
    gidx = mask_to_gt_index(torch.from_numpy(midx.astype(np.int64)), mask.shape,
                            gt.shape).reshape(1, n_cand, k)
    got = rank_candidates(gidx, torch.from_numpy(gt)[None], sampler_name=name,
                          rankings_per_image=rpi, threshold=0.03)[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_f1_ties_go_to_the_lower_index():
    """Equal scores are kept lowest candidate first, as lax.top_k keeps
    them: a pool of lists whose scores all tie keeps the first RPI."""
    gt = torch.full((1, 4, 4), 0.5)
    gidx = torch.arange(16).reshape(1, 8, 2)
    got = rank_candidates(gidx, gt, sampler_name="info_score", rankings_per_image=3)
    assert got[0, :, :, 0].tolist() == [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0]]


def test_f2_predict_fused_on_ff_redweb_is_predict(monkeypatch):
    """ff_redweb has no MBConv block: predict_fused serves predict, and the
    fused encoder (K2's caller) is never reached."""
    import pldepth_torch.models.fused_infer as fused_infer

    def never(*a, **kw):
        raise AssertionError("the fused encoder ran for a model without MBConv blocks")

    monkeypatch.setattr(fused_infer, "encoder_infer", never)
    tr = Trainer(ExperimentConfig(model_name="ff_redweb", input_size=32,
                                  compute_dtype="float32"), device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(3))
    x = np.random.default_rng(4).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    got = tr.predict_fused(state, x)
    assert got.shape == (2, 32, 32)
    assert torch.equal(got, tr.predict(state, x))


@pytest.mark.parametrize("text", ['{"best_val": 0.2', "", '{"step": 3}', "not json"])
def test_f3_unreadable_best_val_resets_tracking(tmp_path, caplog, text):
    (tmp_path / "best_val.json").write_text(text)
    with caplog.at_level(logging.WARNING):
        mgr = CheckpointManager(str(tmp_path))
    assert mgr.best_val == float("inf")
    assert "best-val tracking resets" in caplog.text


def test_f3_truncated_npz_gives_the_default_head_width(tmp_path):
    tr = Trainer(ExperimentConfig(model_name="ff_smoke", input_size=32), device="cpu")
    path = tmp_path / "w.npz"
    save_weights_npz(str(path), tr.init_state())
    data = path.read_bytes()
    path.write_bytes(data[: len(data) // 2])
    assert infer_decoder_head_ch(str(path), default=17) == 17
    path.write_bytes(b"")
    assert infer_decoder_head_ch(str(path), default=17) == 17


def _f4_rankings(bad):
    """B=1, 4x4 maps, RPI=3, K=5 rankings whose list 0 and list 1 each hold
    one index from ``bad``."""
    rng = np.random.default_rng(44)
    idx = rng.integers(0, 16, size=(1, 3, 5)).astype(np.float32)
    idx[0, 0, 1], idx[0, 1, 2] = bad
    labels = rng.uniform(0.1, 1.0, size=(1, 3, 5)).astype(np.float32)
    pred = rng.normal(size=(1, 4, 4, 1)).astype(np.float32)
    return pred, np.stack([idx, labels], -1)


def _port_loss_and_grad(fn, pred, rankings):
    p = torch.from_numpy(pred).requires_grad_(True)
    loss = fn(p, torch.from_numpy(rankings))
    loss.backward()
    return float(loss.detach()), p.grad.numpy()


@pytest.mark.parametrize("bad", [(-1.0, 19.0), (-17.0, 16.0), (-3.5, 1e9)])
def test_f4_out_of_range_ranking_index_gives_nan_like_jax(bad):
    """Out of range after the one wrap (19, 16, -17, 1e9): a NaN loss and
    NaN gradients at the list's other pixels, as JAX's loss gives with
    impl "xla" and "pallas"; never an exception. The trainer refuses the
    step through its finite guard."""
    pred, rankings = _f4_rankings(bad)
    for impl in ("xla", "pallas"):
        j_loss, j_grad = jax.value_and_grad(
            lambda p, impl=impl: j_pl_ranking_loss(p, jnp.asarray(rankings), impl=impl))(
            jnp.asarray(pred))
        j_grad = np.asarray(j_grad)
        assert np.isnan(float(j_loss)) and np.isnan(j_grad).any()
        for fn in (pl_ranking_loss, k1.ranking_loss):
            loss, grad = _port_loss_and_grad(fn, pred, rankings)
            assert np.isnan(loss)
            np.testing.assert_array_equal(np.isnan(grad), np.isnan(j_grad))
            np.testing.assert_allclose(grad, j_grad, rtol=0, atol=1e-6)

    s = 32
    tr = Trainer(ExperimentConfig(model_name="ff_smoke", input_size=s, batch_size=1,
                                  ranking_size=5, rankings_per_image=3,
                                  compute_dtype="float32"), device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    rng = np.random.default_rng(1)
    image = rng.uniform(size=(1, s, s, 3)).astype(np.float32)
    rk = np.stack([rng.integers(0, s * s, (1, 3, 5)), rng.uniform(size=(1, 3, 5))], -1)
    rk[0, 0, 1, 0], rk[0, 1, 2, 0] = -1, s * s + abs(bad[1])
    state, m = tr.train_step_fixed(state, {"image": image, "rankings": rk.astype(np.float32)})
    assert not bool(m.finite) and np.isnan(float(m.loss))
    assert state.step == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_f4_negative_index_wraps_once_like_jax():
    """-1 and -16 + 3 wrap to pixels 15 and 3 of a 4x4 map: the loss and its
    gradient are finite and equal JAX's."""
    pred, rankings = _f4_rankings((-1.0, -13.0))
    j_loss, j_grad = jax.value_and_grad(
        lambda p: j_pl_ranking_loss(p, jnp.asarray(rankings), impl="xla"))(jnp.asarray(pred))
    for fn in (pl_ranking_loss, k1.ranking_loss):
        loss, grad = _port_loss_and_grad(fn, pred, rankings)
        np.testing.assert_allclose(loss, float(j_loss), rtol=1e-6)
        np.testing.assert_allclose(grad, np.asarray(j_grad), rtol=0, atol=1e-6)

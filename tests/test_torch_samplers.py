"""The port's ranking samplers, relations and flip against the JAX package
on the CPU.

torch cannot reproduce threefry, so parity comes in two exact parts and
one distributional part:
  * the draw: every method but ``rejection`` is "the g-th valid pixel"
    (``draw_from_uniform``); given the uniforms ``jax.random.uniform(key,
    (n,))`` yields, it equals ``_masked_uniform_points`` exactly;
  * sort / score / top-k: given the JAX candidate indices, the port's
    rankings equal ``sample_rankings`` exactly, for all five samplers
    (continuous random depths, so no two list scores tie);
  * the statistics of whole draws against tests/golden/sampler_stats.npz,
    with the protocol and TOLERANCES of tools/sampler_parity_check.py.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pldepth_torch.core.rng import generator
from pldepth_torch.data.preprocess import flip_batch
from pldepth_torch.sampling import depth_relation, rank_candidates, sample_rankings_batch
from pldepth_torch.sampling.samplers import (
    SAMPLERS,
    draw_from_uniform,
    mask_to_gt_index,
    masked_uniform_points,
)
from pldepth_tpu.sampling import samplers as js
from pldepth_tpu.sampling.relations import depth_relation as j_depth_relation

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mask(shape, frac, seed):
    return (np.random.default_rng(seed).uniform(size=shape) < frac).astype(np.float32)


@pytest.mark.parametrize("method", ["auto", "hier", "packed", "compact"])
@pytest.mark.parametrize("frac", [0.0, 0.003, 0.5, 1.0])
def test_draw_equals_jax_given_the_same_uniforms(method, frac):
    mask = _mask((37, 41), frac, seed=int(frac * 1000))
    n = 700
    key = jax.random.key(11)
    want = np.asarray(js._masked_uniform_points(key, jnp.asarray(mask.reshape(-1)), n, method))
    u = np.array(jax.random.uniform(key, (n,)))
    got = draw_from_uniform(torch.from_numpy(u)[None], torch.from_numpy(mask.reshape(1, -1)))
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sort_score_topk_equal_jax_given_its_candidates(name):
    rng = np.random.default_rng(5)
    hg, wg = 40, 48
    gt = rng.uniform(0.05, 1.0, (hg, wg)).astype(np.float32)
    # a coarser mask exercises the truncating mask -> gt rescale
    mask = _mask((hg, wg) if name == "segment" else (20, 24), 0.7, seed=6)
    rpi, k = 24, 5
    spec = js.get_sampler(name)
    n_cand = max(int(rpi * spec.oversample_factor), rpi)
    key = jax.random.key(3)
    want = np.asarray(js.sample_rankings(
        key, jnp.asarray(gt), jnp.asarray(mask), sampler_name=name,
        rankings_per_image=rpi, ranking_size=k, threshold=0.03))
    if name == "segment":
        gidx = np.asarray(js._segment_draw(key, jnp.asarray(gt), jnp.asarray(mask),
                                           n_cand, k))
        gidx = torch.from_numpy(gidx.astype(np.int64))[None]
    else:
        midx = np.asarray(js._masked_uniform_points(key, jnp.asarray(mask.reshape(-1)),
                                                    n_cand * k))
        gidx = mask_to_gt_index(torch.from_numpy(midx.astype(np.int64)), mask.shape,
                                gt.shape).reshape(1, n_cand, k)
    got = rank_candidates(gidx, torch.from_numpy(gt)[None], sampler_name=name,
                          rankings_per_image=rpi, threshold=0.03)[0].numpy()
    assert got.shape == want.shape == (rpi, k, 2)
    np.testing.assert_array_equal(got, want)


def _tool():
    spec = importlib.util.spec_from_file_location(
        "sampler_parity_check", os.path.join(REPO, "tools", "sampler_parity_check.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.fixture(scope="module")
def protocol():
    tool = _tool()
    items = tool.protocol_images()
    gts = torch.from_numpy(np.stack([it["gt"] for it in items]))
    masks = torch.from_numpy(np.stack([it["mask"] for it in items]))
    return tool, gts, masks


@pytest.mark.parametrize("name", ["purely_masked", "masked", "thresholded", "info_score"])
def test_sampler_statistics_match_the_reference_golden(protocol, name):
    from pldepth_tpu.diagnostics.chi2 import ranking_stats

    tool, gts, masks = protocol
    ref = np.load(os.path.join(REPO, "tests", "golden", "sampler_stats.npz"))
    mine = []
    for trial in range(tool.TRIALS):
        r = sample_rankings_batch(generator(tool.SEED + trial, "parity"), gts, masks,
                                  sampler_name=name, rankings_per_image=tool.RPI,
                                  ranking_size=tool.K)
        mine.append(ranking_stats(r.numpy().reshape(-1, tool.K, 2)))
    for stat, tol in tool.TOLERANCES.items():
        ref_mean = float(ref[f"{name}/{stat}"])
        our_mean = float(np.mean([s[stat] for s in mine]))
        rel = abs(our_mean - ref_mean) / max(abs(ref_mean), 1e-3)
        assert rel <= tol or abs(our_mean - ref_mean) < 1e-9, (stat, ref_mean, our_mean, rel)


@pytest.mark.parametrize("name", sorted(SAMPLERS))
@pytest.mark.parametrize("method", ["auto", "rejection"])
def test_batch_sampler_contract(name, method):
    """Shapes, list order, in-mask pixels and the gathered depths, for
    every sampler and both draw families."""
    rng = np.random.default_rng(8)
    gts = torch.from_numpy(rng.uniform(0.05, 1.0, (3, 32, 32)).astype(np.float32))
    masks = torch.from_numpy(_mask((3, 32, 32), 0.6, seed=9))
    r = sample_rankings_batch(generator(0, "t"), gts, masks, sampler_name=name,
                              rankings_per_image=10, ranking_size=4, draw_method=method)
    assert r.shape == (3, 10, 4, 2) and r.dtype == torch.float32
    idx = r[..., 0].long()
    assert (r[..., 1][..., :-1] >= r[..., 1][..., 1:]).all()  # descending depth
    assert torch.equal(torch.gather(gts.reshape(3, -1), 1, idx.reshape(3, -1)),
                       r[..., 1].reshape(3, -1))
    if name != "segment":  # segment falls back to global draws only if short of segments
        assert (torch.gather(masks.reshape(3, -1), 1, idx.reshape(3, -1)) > 0).all()


def test_rejection_draws_only_valid_pixels_and_empty_masks_draw_anywhere():
    masks = torch.from_numpy(np.stack([_mask((16, 16), 0.3, seed=1), np.zeros((16, 16),
                                                                             np.float32)]))
    idx = masked_uniform_points(generator(0, "r"), masks.reshape(2, -1), 500, "rejection")
    assert (masks.reshape(2, -1)[0][idx[0]] > 0).all()
    assert idx[1].unique().numel() > 100  # uniform over all pixels


def test_sampler_input_checks():
    gts, masks = torch.rand(1, 8, 8), torch.ones(1, 8, 8)
    kw = dict(rankings_per_image=4, ranking_size=3)
    with pytest.raises(ValueError, match="sampler_draw_method"):
        sample_rankings_batch(generator(0, "t"), gts, masks, sampler_name="masked",
                              draw_method="fancy", **kw)
    with pytest.raises(ValueError, match="unknown sampler"):
        sample_rankings_batch(generator(0, "t"), gts, masks, sampler_name="nope", **kw)
    with pytest.raises(ValueError, match="segments"):
        sample_rankings_batch(generator(0, "t"), gts, masks, sampler_name="segment",
                              rankings_per_image=4, ranking_size=65)
    with pytest.raises(ValueError, match="2\\^24"):
        sample_rankings_batch(generator(0, "t"), torch.zeros(1, 4097, 4097), masks,
                              sampler_name="masked", **kw)


@pytest.mark.parametrize("threshold", [None, 0.03, 0.2])
def test_depth_relation_matches_jax(threshold):
    rng = np.random.default_rng(4)
    d1 = rng.uniform(0, 1, 500).astype(np.float32)
    d2 = np.where(rng.uniform(size=500) < 0.3, d1 * 1.03, rng.uniform(0, 1, 500)).astype(
        np.float32)
    got = depth_relation(torch.from_numpy(d1), torch.from_numpy(d2), threshold).numpy()
    want = np.asarray(j_depth_relation(d1, d2, threshold))
    np.testing.assert_array_equal(got, want)


def test_flip_matches_jax_under_the_same_flags():
    from pldepth_tpu.data.preprocess import random_flip_batch as j_flip

    rng = np.random.default_rng(0)
    images = rng.uniform(size=(6, 5, 7, 3)).astype(np.float32)
    gts = rng.uniform(size=(6, 5, 7)).astype(np.float32)
    masks = (rng.uniform(size=(6, 5, 7)) < 0.5).astype(np.float32)
    key = jax.random.key(2)
    flags = np.asarray(jax.random.bernoulli(key, 0.5, (6,)))
    assert 0 < flags.sum() < 6
    want = j_flip(key, jnp.asarray(images), jnp.asarray(gts), jnp.asarray(masks))
    got = flip_batch(torch.from_numpy(flags), *(torch.from_numpy(a) for a in (images, gts, masks)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

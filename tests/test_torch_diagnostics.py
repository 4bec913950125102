"""The small commands' modules on the CPU, against the JAX package.

Bit-equal, on the same arrays: ``combination_matrix`` and
``batch_combination_matrix`` (data/partial.py); the seeded ordinal pairs
and eval rankings, their npy cache (each package reads the other's file)
and ``pair_agreement_error`` (data/ordinal.py); ``compute_chi_sq`` and
``ranking_stats`` (diagnostics/chi2.py); the images and ``meta.json`` of
``dump_offline_data`` (jpg files byte for byte, the npz archive's images).
Distributional, since the port's lists come from torch generators and not
from threefry: ``run_chi2_compare``'s mean chi^2 within rel 3% of JAX's
(the per-trial spread at this size is ~0.6% of the mean, a difference of
two means of 3 trials ~0.5%; measured at most 0.63% over seeds 0-2 and both
samplers), info_score below purely_masked; the dumped rankings hold the
sampler contract (shape, depth-descending, in the mask, labels = gt at the
index). ``cli dump`` and ``cli chi2`` on the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

from pldepth_torch.core.config import ExperimentConfig
from pldepth_torch.data import ordinal, partial
from pldepth_torch.data.datasets import DepthDataset
from pldepth_torch.data.offline import dump_offline_data, load_offline_rankings
from pldepth_torch.diagnostics.chi2 import compute_chi_sq, ranking_stats, run_chi2_compare
from pldepth_tpu.core.config import ExperimentConfig as JConfig
from pldepth_tpu.data import ordinal as jordinal
from pldepth_tpu.data import partial as jpartial
from pldepth_tpu.data.datasets import DepthDataset as JDepthDataset
from pldepth_tpu.data.offline import dump_offline_data as j_dump
from pldepth_tpu.data.offline import load_offline_rankings as j_load
from pldepth_tpu.diagnostics import chi2 as jchi2

torch.set_num_threads(1)
S = 24


def _load(i):
    rng = np.random.default_rng(70 + i)
    return {"image": rng.uniform(-0.1, 1.1, (S, S + 8, 3)).astype(np.float32),
            "gt": rng.uniform(0.05, 3.0, (S, S + 8)).astype(np.float32),
            "mask": (rng.uniform(size=(S, S + 8)) < 0.8).astype(np.float32)}


def _both(n=5, asc=False):
    items = [_load(i) for i in range(n)]
    return (DepthDataset("np", n, items.__getitem__, asc_depth_order=asc),
            JDepthDataset("np", n, items.__getitem__, asc_depth_order=asc))


@pytest.mark.parametrize("ids", [[0, 0, 1, 2], [0, 1, 1, 2, 2], [3, 1, 2, 1], [0], [1, 1, 1],
                                 [5, 4, 3, 2, 1, 0, 0]])
def test_combination_matrix_equals_jax(ids):
    got, want = partial.combination_matrix(ids), jpartial.combination_matrix(ids)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_batch_combination_matrix_equals_jax():
    rng = np.random.default_rng(0)
    segs = np.stack([np.zeros((3, 5)), rng.integers(0, 3, (3, 5))], -1).astype(np.int64)
    got, want = partial.batch_combination_matrix(segs), jpartial.batch_combination_matrix(segs)
    assert [len(g) for g in got] == [len(w) for w in want]
    for gl, wl in zip(got, want):
        for g, w in zip(gl, wl):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="sane bound"):
        partial.combination_matrix(list(range(21)))


@pytest.mark.parametrize("asc", [False, True])
@pytest.mark.parametrize("invert", [None, False, True])
def test_ordinal_pairs_and_rankings_equal_jax(asc, invert):
    ds, jds = _both(asc=asc)
    got = ordinal.generate_ordinal_pairs(ds, 40, seed=3, threshold=0.05,
                                         invert_relation_sign=invert)
    want = jordinal.generate_ordinal_pairs(jds, 40, seed=3, threshold=0.05,
                                           invert_relation_sign=invert)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    got_r = ordinal.generate_eval_rankings(ds, 7, 4, seed=9, invert_relation_sign=invert)
    want_r = jordinal.generate_eval_rankings(jds, 7, 4, seed=9, invert_relation_sign=invert)
    np.testing.assert_array_equal(got_r, want_r)
    pred = np.random.default_rng(4).uniform(size=S * (S + 8)).astype(np.float32)
    for i in range(len(ds)):
        assert (ordinal.pair_agreement_error(pred, got[i], 0.05)
                == jordinal.pair_agreement_error(pred, want[i], 0.05))
    if not (asc if invert is None else invert):  # gt itself as the prediction
        assert ordinal.pair_agreement_error(ds[0]["gt"].reshape(-1), got[0], 0.05) == 0.0


def test_ordinal_cache_round_trips_across_packages(tmp_path):
    ds, jds = _both()
    mine = ordinal.cached(ordinal.generate_ordinal_pairs, str(tmp_path), "p", ds, 16, 7)
    theirs = jordinal.cached(jordinal.generate_ordinal_pairs, str(tmp_path), "p", jds, 16, 999)
    np.testing.assert_array_equal(mine, theirs)  # JAX read the port's file
    want = jordinal.cached(jordinal.generate_eval_rankings, str(tmp_path), "r", jds, 5, 3, 1)
    got = ordinal.cached(ordinal.generate_eval_rankings, str(tmp_path), "r", ds, 5, 3, 2)
    np.testing.assert_array_equal(got, want)  # the port read JAX's file
    np.testing.assert_array_equal(
        ordinal.cached(ordinal.generate_eval_rankings, str(tmp_path), "r", ds, 5, 3, 1,
                       use_cache=False), want)
    with pytest.raises(ValueError, match="float32-exact"):
        ordinal._check_flat_index_range(4097, 4097)


@pytest.mark.parametrize("k", [3, 5, 8])
def test_chi2_statistics_equal_jax(k):
    rng = np.random.default_rng(k)
    idx = rng.integers(0, 1000, (50, k)).astype(np.float32)
    depths = np.sort(rng.uniform(0.0, 1.0, (50, k)), axis=-1)[:, ::-1].astype(np.float32)
    depths[:5, 1] = depths[:5, 0]  # ties in the ratio test
    r = np.stack([idx, depths], -1)
    assert compute_chi_sq(r, k) == jchi2.compute_chi_sq(r, k)
    for thr in (0.03, 0.1):
        assert ranking_stats(r, thr) == jchi2.ranking_stats(r, thr)


def _chi2_cfg(pkg, sampling_type, seed):
    return pkg(input_size=32, batch_size=4, ranking_size=5, rankings_per_image=100,
               sampling_type=sampling_type, seed=seed, ds_size=16, dataset="synthetic")


@pytest.mark.parametrize("seed", [0, 2])
def test_run_chi2_compare_tracks_jax(seed):
    out = {}
    for st in (1, 3):
        got = run_chi2_compare(_chi2_cfg(ExperimentConfig, st, seed), trials=3,
                               batches_per_trial=4, device="cpu")
        want = jchi2.run_chi2_compare(_chi2_cfg(JConfig, st, seed), trials=3,
                                      batches_per_trial=4)
        assert set(got) == set(want) and got["sampler"] == want["sampler"]
        assert len(got["trials"]) == 3 and np.all(np.isfinite(got["trials"]))
        assert got["mean"] == pytest.approx(want["mean"], rel=0.03)
        out[st] = got["mean"]
    assert out[1] < out[3]  # info_score beats purely_masked (tests/test_samplers.py:99)


def _contract(r, items, rpi, k):
    assert r.shape == (len(items), rpi, k, 2) and r.dtype == np.float32
    for i, s in enumerate(items):
        flat = r[i, ..., 0].astype(np.int64)
        gt, mask = s["gt"].reshape(-1), s["mask"].reshape(-1)
        assert (flat >= 0).all() and (flat < gt.size).all()
        assert (mask[flat] > 0).all()
        np.testing.assert_array_equal(r[i, ..., 1], gt[flat])
        assert (np.diff(r[i, ..., 1], axis=-1) <= 0).all()


@pytest.mark.parametrize("fmt", ["jpg", "npz"])
def test_dump_equals_jax_and_holds_the_sampler_contract(tmp_path, fmt):
    ds, jds = _both(n=20)
    kw = dict(sampler_name="info_score", rankings_per_image=12, ranking_size=4, seed=2,
              image_format=fmt)
    mine = dump_offline_data(ds, str(tmp_path / "mine"), device="cpu", **kw)
    theirs = j_dump(jds, str(tmp_path / "jax"), **kw)
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs))
    assert (json.load(open(os.path.join(mine, "meta.json")))
            == json.load(open(os.path.join(theirs, "meta.json"))))
    if fmt == "jpg":
        for i in range(len(ds)):
            name = f"{i:06d}.jpg"
            assert open(os.path.join(mine, name), "rb").read() == open(
                os.path.join(theirs, name), "rb").read()
    else:
        np.testing.assert_array_equal(np.load(os.path.join(mine, "offline_data.npz"))["images"],
                                      np.load(os.path.join(theirs, "offline_data.npz"))["images"])
    r = load_offline_rankings(mine)
    np.testing.assert_array_equal(r, j_load(mine))
    _contract(r, [ds[i] for i in range(len(ds))], 12, 4)
    assert j_load(theirs).shape == r.shape


def test_dump_needs_a_card_unless_asked(tmp_path, monkeypatch):
    ds, _ = _both(n=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dump_offline_data(ds, str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_chi2_compare(_chi2_cfg(ExperimentConfig, 1, 0), trials=1, batches_per_trial=1)


def test_cli_dump_and_chi2(tmp_path, capsys):
    from pldepth_torch.cli import main
    from pldepth_torch.data.datasets import get_dataset
    from pldepth_torch.data.pipeline import train_val_split

    out = str(tmp_path / "d")
    common = ["--device", "cpu", "--dataset", "scenes", "--input_size", "32",
              "--ds_size", "20", "--ranking_size", "5", "--rankings_per_image", "10"]
    assert main(["dump", *common, "--out_dir", out, "--image_format", "npz"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == out
    train, _ = train_val_split(get_dataset("scenes", size=20, target_size=32))
    items = [train[i] for i in range(len(train))]
    r = load_offline_rankings(out)
    _contract(r, items, 10, 5)
    np.testing.assert_array_equal(
        np.load(os.path.join(out, "offline_data.npz"))["images"],
        np.stack([(np.clip(s["image"], 0, 1) * 255).astype(np.uint8) for s in items]))
    assert main(["chi2", "--device", "cpu", "--input_size", "32", "--dataset", "synthetic",
                 "--ds_size", "16", "--trials", "2", "--batches_per_trial", "2",
                 "--sampling_type", "3"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["sampler"] == "purely_masked" and len(rep["trials"]) == 2
    assert np.isfinite(rep["mean"]) and np.isfinite(rep["variance"])

"""The port's evaluation layer against the JAX package's, on the CPU.

* Host metrics (eval/metrics.py): equal (==) to ``pldepth_tpu.eval.metrics``
  on the same arrays.
* Device metrics (eval/device_metrics.py) with the same injected indices:
  ``pairwise_disagreement`` equal at tau 0 and 0.03, either order, also at
  ratios one float32 ulp either side of the tie band's edges;
  ``ndcg_sampled`` within rel 1e-6 (XLA's log2 and PyTorch's differ by up
  to 4.8e-7). With the port's own draw, ``eval_metrics_batch`` tracks the
  host metrics within 0.03 / 0.03 / 0.05 (tests/test_device_metrics.py's
  bounds).
* The Evaluator on identical predictions (model-free predictors): every
  report equals the JAX package's; ``full_report_device`` tracks the port's
  ``full_report`` within the bounds above.
* The slice as a whole: JAX ff_smoke weights carried across through the
  npz bridge, the same numpy arrays in both packages' DepthDataset, f32 at
  64^2: the two ``full_report``s agree within 1e-3 (test_error,
  whdr_tau_0.03) and rel 1e-5 (ndcg_200).
* ``cli train --parity_report true``, ``cli eval`` and ``cli zeroshot``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pldepth_torch.data.datasets import DepthDataset
from pldepth_torch.eval import Evaluator, device_metrics as D, metrics as M
from pldepth_tpu.data.datasets import DepthDataset as JDepthDataset
from pldepth_tpu.eval import Evaluator as JEvaluator, device_metrics as JD, metrics as JM

torch.set_num_threads(1)
S = 64


def _maps(rng, shape=(S, S), corr=0.8):
    gt = rng.uniform(0.05, 1, shape).astype(np.float32)
    pred = (corr * gt + (1 - corr) * rng.uniform(0, 1, shape)).astype(np.float32)
    return pred, gt


def _smooth(rng, shape=(S, S)):
    """A map with structure (and Canny edges): two steps on a gentle wave."""
    y, x = np.mgrid[: shape[0], : shape[1]] / shape[0]
    a, b, c = rng.uniform(1, 3, 3)
    m = 0.1 * np.sin(a * x * 3) * np.cos(b * y * 2) + (x > c / 4) + (y > 0.5)
    return (m - m.min() + 0.05).astype(np.float32) + rng.uniform(0, 0.02, shape).astype(np.float32)


HOST_CASES = [
    ("ordinal_error", {}, (S, S)),
    ("ordinal_error", {"invert_pred_order": True}, (S, S)),
    ("whdr", {"tau": 0.0}, (S, S)),
    ("whdr", {"tau": 0.03}, (S, S)),
    ("whdr", {"tau": 0.03, "invert_pred_order": True}, (S, S)),
    ("whdr", {"tau": 0.0, "invert_pred_order": True}, (S, S)),
    ("ordinal_error", {}, (40, 40)),  # small-image guard: 800 pairs
    ("whdr", {"tau": 0.03}, (40, 40)),
    ("ndcg_at_k", {}, (S, S)),
    ("ndcg_at_k", {"list_size": 50, "seed": 3}, (40, 40)),
    ("ndcg_at_k", {"constant": True}, (S, S)),
    ("depth_edge_metric", {}, (S, S)),
]


@pytest.mark.parametrize("fn,kw,shape", HOST_CASES)
def test_host_metrics_equal_jax(fn, kw, shape):
    rng = np.random.default_rng(len(fn) + shape[0])
    kw = dict(kw)
    if kw.pop("constant", False):
        pred, gt = np.full(shape, 0.3, np.float32), _smooth(rng, shape)
    elif fn == "depth_edge_metric":
        gt = _smooth(rng, shape)
        pred = gt + rng.normal(0, 0.05, shape).astype(np.float32)
    else:
        pred, gt = _maps(rng, shape)
    got = getattr(M, fn)(pred, gt, **kw)
    want = getattr(JM, fn)(pred, gt, **kw)
    assert got == want
    assert np.all(np.isfinite(got))


def _boundary_pairs(rng, n=S * S):
    """Flat maps (pred, gt) and 600 index pairs: random pairs, plus pairs whose
    ratio lies one float32 ulp below, at and above 1.03 and 1/1.03."""
    pred, gt = _maps(rng, (n,), corr=0.7)
    edges = []
    for r in (np.float32(1.03), np.float32(1 / 1.03)):
        edges += [np.nextafter(r, np.float32(0)), r, np.nextafter(r, np.float32(2))]
    for m in (pred, gt):
        for j, v in enumerate(edges):  # slots 0..5 hold the ratios, 10..15 the 1.0s
            m[j], m[10 + j] = v, np.float32(1.0)
    idx = rng.choice(np.arange(20, n), 1176, replace=False)
    i0 = np.concatenate([np.arange(6), idx[:294], np.arange(10, 16)])
    i1 = np.concatenate([np.arange(10, 16), idx[294:588], np.arange(6)])
    return pred, gt, i0, i1


@pytest.mark.parametrize("tau", [0.0, 0.03])
@pytest.mark.parametrize("invert", [False, True])
def test_pairwise_disagreement_equals_jax(tau, invert):
    rng = np.random.default_rng(1)
    pred, gt, i0, i1 = _boundary_pairs(rng)
    want = float(JD.pairwise_disagreement(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(i0),
                                          jnp.asarray(i1), tau=tau, invert_pred_order=invert))
    got = D.pairwise_disagreement(torch.from_numpy(pred), torch.from_numpy(gt),
                                  torch.from_numpy(i0), torch.from_numpy(i1), tau, invert)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == want
    # batched: (B, n) maps, (B, P) indices -> (B,), each row its image's value
    pred2, gt2, j0, j1 = _boundary_pairs(np.random.default_rng(2))
    batched = D.pairwise_disagreement(
        torch.from_numpy(np.stack([pred, pred2])), torch.from_numpy(np.stack([gt, gt2])),
        torch.from_numpy(np.stack([i0, j0])), torch.from_numpy(np.stack([i1, j1])), tau, invert)
    want2 = float(JD.pairwise_disagreement(jnp.asarray(pred2), jnp.asarray(gt2), jnp.asarray(j0),
                                           jnp.asarray(j1), tau=tau, invert_pred_order=invert))
    assert batched.tolist() == [want, want2]


def test_tie_band_edges_decide_as_jax():
    """Each pair at the band's edges alone: the ratio relation of gt (the
    first six pairs: 1.03 and 1/1.03 and their float32 neighbours, and their
    reverses) decides as in JAX, and the edges fall on both sides."""
    pred, gt, i0, i1 = _boundary_pairs(np.random.default_rng(1))
    flat = np.linspace(0.5, 0.6, gt.size, dtype=np.float32)  # a pred that never ties
    decided = []
    for j in [*range(6), *range(len(i0) - 6, len(i0))]:
        args = (flat, gt, i0[j: j + 1], i1[j: j + 1])
        got = float(D.pairwise_disagreement(*map(torch.from_numpy, args), 0.03))
        want = float(JD.pairwise_disagreement(*map(jnp.asarray, args), tau=0.03))
        assert got == want, j
        decided.append(got)
    assert 0.0 in decided and 1.0 in decided


def test_ndcg_sampled_matches_jax():
    rng = np.random.default_rng(3)
    rows = [_maps(rng, (S * S,)) for _ in range(3)]
    ids = np.stack([rng.choice(S * S, 200, replace=False) for _ in range(3)])
    want = [float(JD.ndcg_sampled(jnp.asarray(p), jnp.asarray(g), jnp.asarray(i)))
            for (p, g), i in zip(rows, ids)]
    for (p, g), i, w in zip(rows, ids, want):
        got = D.ndcg_sampled(torch.from_numpy(p), torch.from_numpy(g), torch.from_numpy(i))
        assert float(got) == pytest.approx(w, rel=1e-6)
    batched = D.ndcg_sampled(torch.from_numpy(np.stack([p for p, _ in rows])),
                             torch.from_numpy(np.stack([g for _, g in rows])),
                             torch.from_numpy(ids))
    np.testing.assert_allclose(batched.numpy(), want, rtol=1e-6)


def test_eval_metrics_batch_tracks_host_metrics():
    rng = np.random.default_rng(4)
    preds, gts = (np.stack(x) for x in zip(*[_maps(rng) for _ in range(4)]))
    gen = torch.Generator().manual_seed(0)
    m = D.eval_metrics_batch(gen, torch.from_numpy(preds), torch.from_numpy(gts), tau=0.03)
    assert {k: tuple(v.shape) for k, v in m.items()} == {
        "ordinal_error": (4,), "whdr": (4,), "ndcg": (4,)}
    for i in range(4):
        assert float(m["ordinal_error"][i]) == pytest.approx(
            M.ordinal_error(preds[i], gts[i]), abs=0.03)
        assert float(m["whdr"][i]) == pytest.approx(M.whdr(preds[i], gts[i], tau=0.03), abs=0.03)
        assert float(m["ndcg"][i]) == pytest.approx(M.ndcg_at_k(preds[i], gts[i]), abs=0.05)


def test_eval_metrics_batch_draws_distinct_pixels():
    gen = torch.Generator().manual_seed(5)
    i0, i1 = D._draw_pairs(gen, 3, 100, 50)  # every pixel of each image
    for row in torch.cat([i0, i1], 1):
        assert sorted(row.tolist()) == list(range(100))
    same = D._draw(torch.Generator().manual_seed(5), 3, 100, 100)
    assert torch.equal(same, torch.cat([i0, i1], 1))  # seeded: reproducible


def test_eval_metrics_batch_perfect_prediction():
    _, gt = _maps(np.random.default_rng(6))
    gts = torch.from_numpy(np.stack([gt, gt]))
    m = D.eval_metrics_batch(torch.Generator().manual_seed(1), gts, gts, tau=0.03)
    assert m["ordinal_error"].tolist() == [0.0, 0.0]
    assert m["whdr"].tolist() == [0.0, 0.0]
    # descending predictions vs ascending gt, inverted comparison -> perfect
    m2 = D.eval_metrics_batch(torch.Generator().manual_seed(2), -gts, gts,
                              invert_pred_order=True)
    assert m2["ordinal_error"].tolist() == [0.0, 0.0]


# -- the Evaluator on identical predictions -----------------------------------
def _samples(n, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        gt = _smooth(rng)
        pred = gt * 0.8 + rng.uniform(0, 0.3, gt.shape).astype(np.float32)
        out.append({"image": np.repeat(pred[..., None], 3, -1), "gt": gt,
                    "mask": np.ones_like(gt)})
    return out


class _RedChannel:
    """A model-free predictor: the image's first channel."""

    def predict(self, state, images):
        return torch.as_tensor(np.asarray(images))[..., 0]


class _JRedChannel:
    def predict(self, state, images):
        return jnp.asarray(images)[..., 0]


def _both(n=5, asc=False, name="toy"):
    samples = _samples(n)
    ds = DepthDataset(name=name, size=n, loader=samples.__getitem__, asc_depth_order=asc)
    jds = JDepthDataset(name=name, size=n, loader=samples.__getitem__, asc_depth_order=asc)
    return (Evaluator(_RedChannel(), None, eval_batch_size=2), ds,
            JEvaluator(_JRedChannel(), None, eval_batch_size=2), jds)


@pytest.mark.parametrize("asc", [False, True])
def test_evaluator_reports_equal_jax(asc):
    ev, ds, jev, jds = _both(5, asc)  # odd: the last batch is padded
    assert ev.full_report(ds) == jev.full_report(jds)
    assert ev.full_report(ds, limit=3, tau=0.1) == jev.full_report(jds, limit=3, tau=0.1)
    for tau in (0.0, 0.03):
        assert ev.calc_err(ds, tau=tau) == jev.calc_err(jds, tau=tau)
    assert ev.dcg_metric(ds) == jev.dcg_metric(jds)
    assert ev.dcg_metric(ds, list_size=50, limit=4) == jev.dcg_metric(jds, list_size=50, limit=4)
    assert ev.calc_depth_metrics(ds) == jev.calc_depth_metrics(jds)
    report = ev.full_report(ds)
    assert set(report) == {"test_error", "whdr_tau_0.03", "ndcg_200", "depth_boundary_metric",
                           "depth_completeness"}


def test_zero_shot_suite_equals_jax():
    ev, ds, jev, jds = _both(5, asc=True, name="ibims")
    _, ds2, _, jds2 = _both(3, asc=False, name="hrwsi")
    got = ev.zero_shot_suite([ds, ds2])
    assert got == jev.zero_shot_suite([jds, jds2])
    assert set(got) == {"ibims", "hrwsi"} and set(got["ibims"]) == {"ordinal_error", "whdr_0.03"}
    assert ev.zero_shot_suite([ds], limit=2) == jev.zero_shot_suite([jds], limit=2)


def test_full_report_without_cv2_has_no_edge_keys(monkeypatch):
    ev, ds, _, _ = _both(3)

    def no_cv2():
        raise RuntimeError("cv2 unavailable: edge metrics require OpenCV")

    monkeypatch.setattr(M, "_cv2", no_cv2)
    assert set(ev.full_report(ds)) == {"test_error", "whdr_tau_0.03", "ndcg_200"}
    with pytest.raises(RuntimeError, match="cv2 unavailable"):
        M.depth_edge_metric(np.zeros((4, 4)), np.zeros((4, 4)))


@pytest.mark.parametrize("asc", [False, True])
def test_full_report_device_tracks_host(asc):
    ev, ds, _, _ = _both(5, asc)
    host = ev.full_report(ds)
    dev = ev.full_report_device(ds)
    assert set(dev) == {"test_error", "whdr_tau_0.03", "ndcg_200"}
    assert dev["test_error"] == pytest.approx(host["test_error"], abs=0.03)
    assert dev["whdr_tau_0.03"] == pytest.approx(host["whdr_tau_0.03"], abs=0.03)
    assert dev["ndcg_200"] == pytest.approx(host["ndcg_200"], abs=0.05)
    assert ev.full_report_device(ds) == dev  # seeded per batch
    assert ev.full_report_device(ds, seed=1) != dev


# -- the slice as a whole -----------------------------------------------------
@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """JAX ff_smoke (f32, 64^2) weights through weights.npz into the port,
    and nine 64^2 samples as numpy arrays for both packages."""
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.train import Trainer
    from pldepth_torch.train.checkpoint import load_weights_npz
    from pldepth_tpu.core.config import ExperimentConfig as JConfig
    from pldepth_tpu.core.mesh import make_mesh
    from pldepth_tpu.train import Trainer as JTrainer
    from pldepth_tpu.train.checkpoint import save_weights_npz

    cfg = dict(model_name="ff_smoke", input_size=S, compute_dtype="float32")
    jtr = JTrainer(JConfig(**cfg), steps_per_epoch=1, mesh=make_mesh(devices=jax.devices()[:1]))
    jstate = jtr.init_state()
    path = str(tmp_path_factory.mktemp("w") / "weights.npz")
    save_weights_npz(path, jstate)
    tr = Trainer(ExperimentConfig(**cfg), steps_per_epoch=1, device="cpu")
    state = load_weights_npz(path, tr.init_state())
    rng = np.random.default_rng(11)
    samples = []
    for _ in range(9):
        gt = _smooth(rng)
        image = np.stack([gt / gt.max(), _smooth(rng) / 4, rng.uniform(0, 1, gt.shape)], -1)
        samples.append({"image": image.astype(np.float32), "gt": gt, "mask": np.ones_like(gt)})
    return jtr, jstate, tr, state, samples, path


def test_slice_full_report_matches_jax(carried):
    """Measured gaps (CPU, f32, either order): test_error 0, whdr_tau_0.03
    0, ndcg_200 rel 1.9e-8, the edge metrics 0. The two f32 forwards differ
    by 1.2e-6 of max|pred|, too little to flip a sampled pair here."""
    jtr, jstate, tr, state, samples, _ = carried
    for asc in (False, True):
        ds = DepthDataset("toy", len(samples), samples.__getitem__, asc_depth_order=asc)
        jds = JDepthDataset("toy", len(samples), samples.__getitem__, asc_depth_order=asc)
        got = Evaluator(tr, state).full_report(ds)
        want = JEvaluator(jtr, jstate).full_report(jds)
        assert set(got) == set(want)
        assert abs(got["test_error"] - want["test_error"]) <= 1e-3
        assert abs(got["whdr_tau_0.03"] - want["whdr_tau_0.03"]) <= 1e-3
        assert got["ndcg_200"] == pytest.approx(want["ndcg_200"], rel=1e-5)
        dev = Evaluator(tr, state).full_report_device(ds)
        assert dev["test_error"] == pytest.approx(got["test_error"], abs=0.03)
        assert dev["whdr_tau_0.03"] == pytest.approx(got["whdr_tau_0.03"], abs=0.03)
        assert dev["ndcg_200"] == pytest.approx(got["ndcg_200"], abs=0.05)


# -- the CLI ------------------------------------------------------------------
def _main(capsys, *argv):
    from pldepth_torch.cli import main

    assert main(list(argv)) == 0
    return capsys.readouterr().out


def test_cli_train_parity_report(tmp_path, capsys):
    """The JAX twin: tests/test_cli_train.py::test_train_parity_report."""
    out = _main(capsys, "train", "--device", "cpu", "--model_name", "ff_smoke",
                "--dataset", "synthetic", "--input_size", str(S), "--ds_size", "32",
                "--epochs", "1", "--parity_report", "true", "--parity_target_whdr", "1.0",
                "--output_dir", str(tmp_path), "--run_name", "rp")
    run = tmp_path / "rp"
    summary = json.loads((run / "summary.json").read_text())
    assert set(summary) == {"test_error", "ndcg_200"}
    lines = out.strip().splitlines()
    assert json.loads(next(ln for ln in lines if ln.startswith('{"test_error"'))) == summary
    assert sorted(os.listdir(run / "examples")) == ["ex_gt.png", "ex_img.png", "ex_pred.png"]
    report = json.loads((run / "parity_report.json").read_text())
    assert set(report) == {"test_error", "whdr_tau_0.03", "ndcg_200", "depth_boundary_metric",
                           "depth_completeness", "config", "parity"}
    assert report["test_error"] == summary["test_error"]
    assert report["config"] == {"model_name": "ff_smoke", "input_size": S, "ranking_size": 3,
                                "dataset": "synthetic", "ds_size": 32, "epochs": 1,
                                "sampling_type": 1}
    assert report["parity"] == {"target_whdr": 1.0, "budget": 0.005, "pass": True}
    assert any(ln.startswith("PARITY PASS: WHDR ") for ln in lines)
    assert json.loads(lines[-1])["weights"] == str(run / "weights.npz")


def test_cli_train_without_parity_target_gives_no_verdict(tmp_path, capsys):
    out = _main(capsys, "train", "--device", "cpu", "--model_name", "ff_smoke",
                "--dataset", "synthetic", "--input_size", str(S), "--ds_size", "32",
                "--epochs", "1", "--parity_report", "true",
                "--output_dir", str(tmp_path), "--run_name", "rn")
    report = json.loads((tmp_path / "rn" / "parity_report.json").read_text())
    assert "parity" not in report and "PARITY" not in out


@pytest.fixture(scope="module")
def port_weights(tmp_path_factory):
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.train import Trainer
    from pldepth_torch.train.checkpoint import save_weights_npz

    tr = Trainer(ExperimentConfig(model_name="ff_smoke", input_size=S), device="cpu")
    path = str(tmp_path_factory.mktemp("pw") / "weights.npz")
    save_weights_npz(path, tr.init_state())
    return path


@pytest.mark.parametrize("device_metrics", ["false", "true"])
def test_cli_eval(port_weights, capsys, device_metrics):
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.data.datasets import get_dataset
    from pldepth_torch.train import Trainer
    from pldepth_torch.train.checkpoint import load_weights_npz

    out = json.loads(_main(capsys, "eval", "--device", "cpu", "--model_name", "ff_smoke",
                           "--load_model_path", port_weights, "--dataset", "synthetic",
                           "--input_size", str(S), "--limit", "5",
                           "--device_metrics", device_metrics))
    tr = Trainer(ExperimentConfig(model_name="ff_smoke", input_size=S), device="cpu")
    ev = Evaluator(tr, load_weights_npz(port_weights, tr.init_state()))
    ds = get_dataset("synthetic", target_size=S, size=5)
    if device_metrics == "true":
        assert out == ev.full_report_device(ds)
        host = ev.full_report(ds)
        for key, tol in (("test_error", 0.03), ("whdr_tau_0.03", 0.03), ("ndcg_200", 0.05)):
            assert out[key] == pytest.approx(host[key], abs=tol)
    else:
        assert out == ev.full_report(ds)
        assert set(out) >= {"test_error", "whdr_tau_0.03", "ndcg_200"}

"""Active learning on the CPU, against the JAX package.

The acquisition functions are held exactly: ``tile_hausdorff`` (numpy) and
``tile_hausdorff_batch`` (torch on the CPU, in one chunk and in chunks of
one image) equal JAX's ``tile_hausdorff`` and jitted ``tile_hausdorff_batch``
bit for bit (distances and witnesses) at split 4 and 8, on a batch of 3, a
non-square map, tiles empty on either side and maps built to tie; the edge
maps, ``acquire_pixels`` and ``oracle_label`` equal JAX's on the same arrays
and seed. The round as a whole (``ff_smoke`` f32 at 64^2, JAX's initial
weights carried across by the weight bridge, JAX on a one-device mesh),
streaming and resident, each path against its own JAX twin: on JAX's
predictions it is exact; on its own, the predicted u8 maps that Canny sees
must agree (a pixel that rounds the other way is reported and bounded), the
edge maps must be equal, then the images, rankings and statistics. ``fit_on_fixed_rankings``' loss is within rel
1e-5 of JAX's with ``listmle_impl="xla"`` (``adam_eps`` 1e-2 as in
tests/test_torch_train_slice.py, so the second step does not hang on
AMSGrad's sign-of-noise first update). Also: ``run_active_loop``'s history
keys, ``jit_predict_resident`` against ``predict``, and ``cli active``.
"""

import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from pldepth_torch.active import acquisition as acq
from pldepth_torch.active import loop
from pldepth_torch.core.config import ExperimentConfig
from pldepth_torch.data.datasets import DepthDataset
from pldepth_torch.data.resident import build_resident_store
from pldepth_torch.data.scenes import SceneDepthDataset
from pldepth_torch.train import Trainer
from pldepth_torch.train.checkpoint import load_weights_npz
from pldepth_tpu.active import acquisition as jacq
from pldepth_tpu.active import loop as jloop
from pldepth_tpu.core.config import ExperimentConfig as JConfig
from pldepth_tpu.core.mesh import make_mesh
from pldepth_tpu.data import build_resident_store as j_build_resident_store
from pldepth_tpu.data.datasets import DepthDataset as JDepthDataset
from pldepth_tpu.train import Trainer as JTrainer
from pldepth_tpu.train.checkpoint import save_weights_npz as j_save_weights_npz

torch.set_num_threads(1)
S = 64
N_POOL = 6
CFG = dict(model_name="ff_smoke", input_size=S, batch_size=2, ranking_size=3,
           rankings_per_image=8, sampling_type=1, compute_dtype="float32",
           initial_lr=0.01, adam_eps=1e-2, epochs=1, listmle_impl="xla")


def _edges(rng, shape, p):
    return (rng.uniform(size=shape) < p).astype(np.uint8) * 255


def _tie_tile(a, b, r0, c0):
    """Two 8x8 tiles built to tie: every A pixel 3 from B's single pixel
    (argmax ties), and a B pixel whose two nearest A pixels are both 4 away
    (argmin ties)."""
    for r, c in ((0, 3), (3, 0), (6, 3), (3, 6)):
        a[r0 + r, c0 + c] = 255
    b[r0 + 3, c0 + 3] = 255
    a[r0 + 3, c0 + 15] = a[r0 + 7, c0 + 11] = 255
    b[r0 + 7, c0 + 15] = b[r0 + 7, c0 + 10] = b[r0 + 2, c0 + 15] = 255


def _cases():
    rng = np.random.default_rng(3)
    out = {}
    # sparse, dense, fully empty A
    a = np.stack([_edges(rng, (S, S), p) for p in (0.02, 0.15, 0.0)])
    b = np.stack([_edges(rng, (S, S), p) for p in (0.15, 0.02, 0.1)])
    out["b3_split8"] = (a, b, 8)
    out["b3_split4"] = (a[:, :32, :32], b[:, :32, :32], 4)
    for h, w in ((64, 48), (48, 64), (67, 53)):  # non-square, with a ragged border
        out[f"{h}x{w}"] = (np.stack([_edges(rng, (h, w), 0.1) for _ in range(3)]),
                           np.stack([_edges(rng, (h, w), 0.1) for _ in range(3)]), 8)
    # tiles empty on one side or the other (and on both)
    a, b = _edges(rng, (2, S, S), 0.1), _edges(rng, (2, S, S), 0.1)
    a[0, :16, :] = 0
    b[0, 16:32, :] = 0
    a[1, :, :24] = b[1, :, 16:40] = 0
    out["empty_tiles"] = (a, b, 8)
    # built to tie, alone and over a sparse background
    a, b = np.zeros((3, S, S), np.uint8), np.zeros((3, S, S), np.uint8)
    for i in range(3):
        for t in range(0, S, 16):
            _tie_tile(a[i], b[i], t, (t + 16 * i) % 48)
    a[2] |= _edges(rng, (S, S), 0.01)
    out["ties"] = (a, b, 4)
    out["ties_split8"] = (a, b, 8)
    return out


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_hausdorff_equals_jax(case, monkeypatch):
    a, b, split = CASES[case]
    want_b = jacq.tile_hausdorff_batch(a, b, split)
    for i in range(a.shape[0]):
        want = jacq.tile_hausdorff(a[i], b[i], split)
        got = acq.tile_hausdorff(a[i], b[i], split)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        for g, w in zip(got, (want_b[0][i], want_b[1][i])):
            np.testing.assert_array_equal(g, w)
    got_b = acq.tile_hausdorff_batch(a, b, split, "cpu")
    assert got_b[0].dtype == np.float32 and got_b[1].dtype == np.int64
    for g, w in zip(got_b, want_b):
        np.testing.assert_array_equal(g, w)
    # chunked one image at a time: the same results
    monkeypatch.setattr(acq, "HAUSDORFF_CHUNK_BYTES", 1)
    for g, w in zip(acq.tile_hausdorff_batch(a, b, split, "cpu"), want_b):
        np.testing.assert_array_equal(g, w)


def test_tile_hausdorff_batch_needs_a_card_unless_asked(monkeypatch):
    a, b, split = CASES["b3_split8"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        acq.tile_hausdorff_batch(a, b, split)


@pytest.fixture(scope="module")
def scenes():
    ds = SceneDepthDataset(N_POOL, S, seed=5)
    return [ds[i] for i in range(N_POOL)]


@pytest.mark.parametrize("sigma", [1.8, 0.33])
def test_edge_maps_and_acquisition_equal_jax(scenes, sigma):
    rng = np.random.default_rng(1)
    for s in scenes:
        pred = s["gt"] + rng.normal(0, 0.05, s["gt"].shape).astype(np.float32)
        np.testing.assert_array_equal(acq.input_edge_map(s["image"]),
                                      jacq.input_edge_map(s["image"]))
        np.testing.assert_array_equal(acq.pred_edge_map(pred, sigma),
                                      jacq.pred_edge_map(pred, sigma))
        for split in (4, 8):
            got = acq.acquire_pixels(s["image"], pred[..., None], split, sigma)
            want = jacq.acquire_pixels(s["image"], pred[..., None], split, sigma)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            pts = got[1]
            for k in (3, 5):
                np.testing.assert_array_equal(
                    acq.oracle_label(s["gt"], pts, k, np.random.default_rng(k)),
                    jacq.oracle_label(s["gt"], pts, k, np.random.default_rng(k)))


@pytest.fixture(scope="module")
def carried(tmp_path_factory, scenes):
    """JAX ff_smoke (f32, 64^2) weights through weights.npz into the port;
    the pool as a dataset of each package over the same arrays."""
    jtr = JTrainer(JConfig(**CFG), steps_per_epoch=1, mesh=make_mesh(devices=jax.devices()[:1]))
    jstate = jtr.init_state()
    path = str(tmp_path_factory.mktemp("w") / "weights.npz")
    j_save_weights_npz(path, jstate)
    tr = Trainer(ExperimentConfig(**CFG), steps_per_epoch=1, device="cpu")
    state = load_weights_npz(path, tr.init_state())
    ds = DepthDataset("pool", N_POOL, scenes.__getitem__)
    jds = JDepthDataset("pool", N_POOL, scenes.__getitem__)
    return jtr, jstate, tr, state, ds, jds, path


def _sharp_u8(pred):
    """The u8 map Canny sees in ``pred_edge_map`` (minmax, unsharp mask)."""
    import cv2

    pred_u8 = acq._minmax(np.squeeze(pred).astype(np.float32), 0, 255)
    blurred = cv2.GaussianBlur(pred_u8, (5, 5), 1.0)
    return np.clip(4.0 * pred_u8 - 3.0 * blurred, 0, 255).round().astype(np.uint8)


def _stores(ds, jds, jtr, resident):
    if not resident:
        return None, None
    return build_resident_store(ds, "cpu"), j_build_resident_store(jds, jtr.mesh)


@pytest.mark.parametrize("resident", [False, True])
def test_round_on_jax_predictions_equals_jax(carried, resident, monkeypatch):
    """The round's own work (batches, the tail's skipped rows, edge maps,
    Hausdorff, the oracle's draws in row order) on the same prediction
    arrays: the port's trainer serves JAX's predictions. Exact."""
    jtr, jstate, tr, state, ds, jds, _ = carried
    store, jstore = _stores(ds, jds, jtr, resident)
    monkeypatch.setattr(tr, "jit_predict", lambda: (
        lambda st, imgs: np.asarray(jtr.jit_predict()(jstate, imgs))))
    monkeypatch.setattr(tr, "jit_predict_resident", lambda bl: (
        lambda st, u8, start: np.asarray(
            jtr.jit_predict_resident(bl)(jstate, jstore.arrays["image"], start))))
    got = loop.active_learning_round(tr, state, ds, split=4, seed=3, predict_batch=4,
                                     store=store)
    want = jloop.active_learning_round(jtr, jstate, jds, split=4, seed=3, predict_batch=4,
                                       store=jstore)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert got[2] == want[2]


@pytest.mark.parametrize("resident", [False, True])
def test_active_learning_round_equals_jax(carried, resident):
    """Each package's round on its own predictions (predict_batch 4 over 6
    rows: the streaming path pads its last batch, the resident one overlaps
    rows 2 and 3, which must not draw again). The f32 forwards differ by at
    most 1.1e-6 of max|pred| (bound 1e-5), so a u8 pixel that Canny sees
    may round the other way: measured one pixel by one unit of 24576 on
    either path (image 5 streaming, image 4 resident), reported as a
    warning; bound: one unit, at most
    0.1% of the pixels. The edge maps must then agree, and the images,
    rankings and statistics be equal."""
    jtr, jstate, tr, state, ds, jds, _ = carried
    store, jstore = _stores(ds, jds, jtr, resident)
    if resident:
        got_pred = np.concatenate([np.asarray(tr.jit_predict_resident(3)(
            state, store.arrays["image"], s)) for s in (0, 3)])
        want_pred = np.concatenate([np.asarray(jtr.jit_predict_resident(3)(
            jstate, jstore.arrays["image"], s)) for s in (0, 3)])
    else:
        images = np.stack([ds[i]["image"] for i in range(N_POOL)])
        got_pred = np.asarray(tr.jit_predict()(state, images))
        want_pred = np.asarray(jtr.jit_predict()(jstate, images))
    assert np.abs(got_pred - want_pred).max() <= 1e-5 * np.abs(want_pred).max()
    u8_got = np.stack([_sharp_u8(g) for g in got_pred]).astype(np.int16)
    u8_want = np.stack([_sharp_u8(w) for w in want_pred]).astype(np.int16)
    differ = u8_got != u8_want
    if differ.any():
        warnings.warn(f"{int(differ.sum())} of {differ.size} predicted u8 pixels differ from "
                      f"JAX's (images {sorted(set(np.nonzero(differ)[0].tolist()))}), by at "
                      f"most {int(np.abs(u8_got - u8_want).max())}")
    assert np.abs(u8_got - u8_want).max() <= 1 and differ.mean() <= 1e-3
    for g, w in zip(got_pred, want_pred):
        np.testing.assert_array_equal(acq.pred_edge_map(g), jacq.pred_edge_map(w))

    got = loop.active_learning_round(tr, state, ds, split=4, seed=3, predict_batch=4,
                                     store=store)
    want = jloop.active_learning_round(jtr, jstate, jds, split=4, seed=3, predict_batch=4,
                                       store=jstore)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].shape == (N_POOL, 16 // 3, 3, 2) and got[1].dtype == np.float32
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert got[2] == want[2]


def test_fit_on_fixed_rankings_equals_jax(carried):
    """Two steps of batch 2 on acquired lists; measured rel 6e-8."""
    jtr, jstate, tr, state, ds, jds, _ = carried
    images, rankings, _ = jloop.active_learning_round(jtr, jstate, jds, split=4, seed=0)
    _, want = jloop.fit_on_fixed_rankings(jtr, jstate, images, rankings, 2, seed=4)
    new, got = loop.fit_on_fixed_rankings(tr, state, images, rankings, 2, seed=4)
    assert got == pytest.approx(want, rel=1e-5)
    assert new.step == state.step + 2


def test_run_active_loop_history_has_the_jax_keys(carried):
    _, _, tr, state, ds, _, _ = carried
    _, history = loop.run_active_loop(tr, state, ds, rounds=2, split=4, eval_ds=ds,
                                      eval_limit=4, seed=1)
    assert list(history) == ["loss", "err", "hd_mean"]
    assert all(len(v) == 2 and np.all(np.isfinite(v)) for v in history.values())
    _, history = loop.run_active_loop(tr, state, ds, rounds=1, split=4)
    assert history["err"] == [] and len(history["loss"]) == 1


def test_jit_predict_resident_equals_predict(carried):
    _, _, tr, state, ds, _, _ = carried
    store = build_resident_store(ds, "cpu")
    u8 = store.arrays["image"]
    fn = tr.jit_predict_resident(4)
    assert tr.jit_predict_resident(4) is fn
    for start in (0, 2):
        want = tr.predict(state, u8[start: start + 4].to(torch.float32) / 255.0).numpy()
        np.testing.assert_array_equal(fn(state, u8, start), want)


@pytest.mark.parametrize("resident,load", [("false", False), ("true", True)])
def test_cli_active_writes_weights(carried, tmp_path, capsys, resident, load):
    from pldepth_torch.cli import main

    argv = ["active", "--device", "cpu", "--model_name", "ff_smoke", "--dataset", "scenes",
            "--input_size", str(S), "--ds_size", "16", "--batch_size", "4",
            "--ranking_size", "3", "--rounds", "1", "--split_num", "4",
            "--data_resident", resident, "--output_dir", str(tmp_path)]
    argv += ["--load_model_path", carried[-1]] if load else ["--pretrain_epochs", "1"]
    assert main(argv) == 0
    history = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(history) == {"loss", "err", "hd_mean"} and len(history["err"]) == 1
    (run,) = os.listdir(tmp_path)
    assert run.endswith("_active")
    assert os.path.exists(tmp_path / run / "weights.npz")
    rows = [json.loads(line) for line in open(tmp_path / run / "metrics.jsonl")]
    assert [r["active_round"] for r in rows if "active_round" in r] == [0]

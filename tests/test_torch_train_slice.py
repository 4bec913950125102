"""The training slice as a whole on the CPU, against the JAX package.

``ff_smoke`` in f32 at 64^2, the JAX package's initial weights carried
across by the weight bridge, the same fixed rankings: after 1 and 3
``train_step_fixed`` steps the loss (rel 1e-6), the params and the BN
statistics (atol 1e-5, rtol 1e-5) match the JAX step. ``adam_eps`` is
1e-2 in that comparison: ListMLE is shift invariant, so the true gradient
of some leaves (the head bias) is 0, and at eps 1e-7 AMSGrad's first step
is lr * sign(f32 noise) in either package; the optimizer itself is held
against optax in tests/test_torch_train_parts.py. ff_smoke's one residual
block has drop rate 0, so drop-path cannot differ (it has its own test).

Also: the finite guard and the NaN stop, ``fit`` with validation and a
frozen encoder, checkpoint rotation and best-val tracking, the CSV log, a
SIGTERM mid-epoch bitwise resume (tests/test_resume.py's protocol), the
batch stream, ``--config_json`` precedence, and ``cli train`` writing a
``weights.npz`` that both packages load.
"""

import json
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from pldepth_torch.core.config import ExperimentConfig
from pldepth_torch.data.datasets import DepthDataset, SyntheticDepthDataset
from pldepth_torch.data.pipeline import BatchIterator, pregenerate_val_rankings, val_batches
from pldepth_torch.models.pretrained import flax_from_state_dict, load_flat
from pldepth_torch.train import Trainer
from pldepth_torch.train.checkpoint import CheckpointManager
from pldepth_tpu.core.config import ExperimentConfig as JConfig
from pldepth_tpu.core.mesh import make_mesh
from pldepth_tpu.train import Trainer as JTrainer

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 64
STEP_CFG = dict(model_name="ff_smoke", input_size=S, batch_size=2, ranking_size=5,
                rankings_per_image=16, compute_dtype="float32", freeze_encoder=True,
                augmentation=False, initial_lr=0.01, adam_eps=1e-2, epochs=1)


def flat_jax(state):
    tree = {"params": jax.device_get(state.params),
            "batch_stats": jax.device_get(state.batch_stats)}
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _fixed_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        idx = rng.integers(0, S * S, (2, 16, 5))
        depths = np.sort(rng.uniform(0.1, 1.0, (2, 16, 5)), axis=-1)[..., ::-1]
        out.append({"image": rng.uniform(size=(2, S, S, 3)).astype(np.float32),
                    "rankings": np.stack([idx, depths], -1).astype(np.float32)})
    return out


@pytest.fixture(scope="module")
def jax_run():
    """The JAX trainer's initial weights and its state after 1..3 fixed
    steps, plus a step on a NaN image."""
    jtr = JTrainer(JConfig(**STEP_CFG), steps_per_epoch=3,
                   mesh=make_mesh(devices=jax.devices()[:1]))
    state = jtr.init_state()
    out = {"init": flat_jax(state), "losses": [], "after": []}
    for b in _fixed_batches(3):
        state, m = jtr.train_step_fixed(state, b)
        out["losses"].append(float(m.loss))
        out["after"].append(flat_jax(state))
    bad = dict(_fixed_batches(1, seed=9)[0])
    bad["image"] = bad["image"].copy()
    bad["image"][0, 3, 4, 1] = np.nan
    nstate, m = jtr.train_step_fixed(state, bad)
    out["nan"] = (bool(m.finite), int(jax.device_get(nstate.step)), flat_jax(nstate))
    return out


def _port(flat, **kw):
    tr = Trainer(ExperimentConfig(**{**STEP_CFG, **kw}), steps_per_epoch=3, device="cpu")
    state = tr.init_state()
    loaded, skipped = load_flat(state.model, flat)
    assert skipped == 0 and loaded == len(state.model.state_dict())
    return tr, state


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_step_fixed_matches_jax(jax_run, n_steps):
    tr, state = _port(jax_run["init"])
    for i, b in enumerate(_fixed_batches(n_steps)):
        state, m = tr.train_step_fixed(state, b)
        assert bool(m.finite)
        np.testing.assert_allclose(float(m.loss), jax_run["losses"][i], rtol=1e-6)
    assert state.step == n_steps and int(state.opt.count) == n_steps
    got = flax_from_state_dict(state.model.state_dict())
    want = jax_run["after"][n_steps - 1]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    # frozen encoder convs did not move; BN affine and statistics did
    init = jax_run["init"]
    for k in want:
        moved = not np.array_equal(got[k], init[k])
        if k.startswith("params/encoder") and k.endswith("kernel"):
            assert not moved, k
        if k.startswith("batch_stats") or "/stem_bn/" in k:
            assert moved, k


def test_finite_guard_keeps_state_but_advances_step(jax_run):
    tr, state = _port(jax_run["init"])
    for b in _fixed_batches(3):
        state, _ = tr.train_step_fixed(state, b)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt_before = {k: v.clone() for k, v in state.opt.state_dict().items()}
    bad = dict(_fixed_batches(1, seed=9)[0])
    bad["image"] = bad["image"].copy()
    bad["image"][0, 3, 4, 1] = np.nan
    state, m = tr.train_step_fixed(state, bad)
    j_finite, j_step, j_flat = jax_run["nan"]
    assert bool(m.finite) is j_finite is False
    assert state.step == j_step == 4
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in state.opt.state_dict().items():
        assert torch.equal(v, opt_before[k]), k
    got = flax_from_state_dict(state.model.state_dict())
    for k in j_flat:
        np.testing.assert_allclose(got[k], j_flat[k], rtol=1e-5, atol=1e-5, err_msg=k)


def _tiny(**kw):
    cfg = ExperimentConfig(**{**dict(model_name="ff_smoke", input_size=S, batch_size=4,
                                     ranking_size=3, rankings_per_image=8, sampling_type=1,
                                     freeze_encoder=False, compute_dtype="float32",
                                     initial_lr=3e-4, epochs=1), **kw})
    return cfg, Trainer(cfg, steps_per_epoch=3, device="cpu")


def _params(state):
    return [p.detach().clone() for p in state.model.parameters()]


class _StopAfter:
    """Wrap an iterator; run ``action`` when the n-th batch is fetched."""

    def __init__(self, it, n, action):
        self.it, self.n, self.action, self.count = it, n, action, 0

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self.it)
        self.count += 1
        if self.count == self.n:
            self.action()
        return batch

    def close(self):
        self.it.close()


def test_sigterm_mid_epoch_checkpoint_then_bitwise_resume(tmp_path):
    cfg, trainer = _tiny()
    ds = SyntheticDepthDataset(n=12, image_size=S, seed=0)
    it = BatchIterator(ds, 4, seed=0)
    state_a, _ = trainer.fit(trainer.init_state(), it, epochs=1)
    it.close()
    ref = _params(state_a)

    # SIGTERM while fetching the 3rd batch: fit stops after step 2 and saves
    mgr = CheckpointManager(str(tmp_path / "auto"), keep=2)
    it = _StopAfter(BatchIterator(ds, 4, seed=0), 3, lambda: os.kill(os.getpid(), signal.SIGTERM))
    _, hist_b = trainer.fit(trainer.init_state(), it, epochs=1, ckpt=mgr)
    it.close()
    assert hist_b.get("preempted") is True
    assert mgr.latest_step() == 2

    restored = mgr.restore(trainer.init_state(torch.Generator().manual_seed(5)))
    assert restored.step == 2 and int(restored.opt.count) == 2
    it = BatchIterator(ds, 4, seed=0, start_step=2)
    state_c, hist_c = trainer.fit(restored, it, epochs=1)
    it.close()
    assert hist_c.get("preempted") is None
    for a, c in zip(ref, _params(state_c)):
        assert torch.equal(a, c)


def test_fit_with_validation_frozen_encoder_and_checkpoints(tmp_path):
    cfg, trainer = _tiny(freeze_encoder=True, epochs=2, keep_checkpoints=1)
    ds = SyntheticDepthDataset(n=12, image_size=S, seed=3)
    rankings = pregenerate_val_rankings(ds.take(4), sampler_name="thresholded",
                                        rankings_per_image=8, ranking_size=3)
    assert rankings.shape == (4, 8, 3, 2)
    state = trainer.init_state()
    frozen = {n: p.detach().clone() for n, p in state.model.named_parameters()
              if not p.requires_grad}
    bn_var = state.model.encoder.stem_bn.running_var.clone()
    gamma = state.model.encoder.stem_bn.weight.detach().clone()
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=1)
    it = BatchIterator(ds, 4, seed=1)
    state, history = trainer.fit(state, it, val_iter_factory=lambda: val_batches(
        ds.take(4), rankings, 4), ckpt=mgr)
    it.close()
    assert state.step == 6 and len(history["loss"]) == len(history["val_loss"]) == 2
    assert np.isfinite(history["val_loss"]).all() and mgr.steps() == [6]
    params = dict(state.model.named_parameters())
    assert frozen and all(torch.equal(params[n], v) for n, v in frozen.items())
    assert not torch.equal(state.model.encoder.stem_bn.running_var, bn_var)
    assert not torch.equal(state.model.encoder.stem_bn.weight, gamma)


def test_batch_stream_equals_jax():
    from pldepth_tpu.data.pipeline import BatchIterator as JIterator

    ds = DepthDataset("idx", 10, lambda i: {"i": np.array([i])})
    for start in (0, 4):
        a, b = BatchIterator(ds, 4, seed=3, start_step=start), JIterator(ds, 4, seed=3,
                                                                         start_step=start)
        got = [next(a)["i"][:, 0].tolist() for _ in range(5)]
        want = [next(b)["i"][:, 0].tolist() for _ in range(5)]
        a.close()
        b.close()
        assert got == want


def test_config_json_precedence_matches_jax():
    from pldepth_torch.cli import _make_config, _parser
    from pldepth_tpu.cli import _make_config as j_make_config

    path = os.path.join(REPO, "configs", "ff_effnet_448.json")
    kw = vars(_parser().parse_args(["train", "--config_json", path, "--batch_size", "32"]))
    got = json.loads(_make_config(kw).to_json())
    want = j_make_config({k: v for k, v in kw.items() if k not in ("command", "device")}).to_dict()
    assert got == json.loads(json.dumps(want, default=str))
    # the CLI's own defaults win over the file where they differ from the
    # config defaults (freeze_encoder false, dataset synthetic)
    assert (got["input_size"], got["batch_size"], got["freeze_encoder"]) == (448, 32, False)


SMALL_RUN = ["--model_name", "ff_smoke", "--input_size", "64", "--ds_size", "8", "--batch_size",
             "2", "--epochs", "1", "--rankings_per_image", "8", "--compute_dtype", "float32"]


@pytest.mark.parametrize("flags,item", [
    pytest.param(["--mesh_model", "4"], "make_mesh", id="flags1-item 11"),
    pytest.param(["--mesh_model", "2"], "make_mesh", id="flags2-item 11"),
    pytest.param(["--spatial_sharding", "true"], "no-op", id="flags3-item 11"),
    pytest.param(["--spatial_sharding", "true", "--qres", "int8"], "no-op",
                 id="flags6-item 11"),
])
def test_cli_train_unported_options_name_their_item(flags, item, tmp_path):
    """The mesh flags at world 1 (one process), as the JAX package has them:
    a model axis that does not divide the world is ``make_mesh``'s error
    (``MeshConfig.resolved_data``: the same message, nothing written; JAX
    asserts, the port raises ValueError); ``--spatial_sharding`` with a
    model axis of 1 is a no-op (``_spatial_axis`` is None), so the run
    equals the same run without the flag."""
    from pldepth_torch.cli import _parser, main, train
    from pldepth_tpu.core.config import MeshConfig as JMeshConfig

    if item == "make_mesh":
        with pytest.raises(AssertionError) as want:
            make_mesh(JMeshConfig(model=int(flags[1])), devices=jax.devices()[:1])
        with pytest.raises(ValueError) as got:
            main(["train", "--device", "cpu", "--output_dir", str(tmp_path), *flags])
        assert str(got.value) == str(want.value)
        assert not any(tmp_path.iterdir())  # nothing written
        return
    jtr = JTrainer(JConfig(model_name="ff_smoke", input_size=64, spatial_sharding=True),
                   steps_per_epoch=1, mesh=make_mesh(devices=jax.devices()[:1]))
    assert jtr._spatial_axis() is None
    base = ["train", "--device", "cpu", "--output_dir", str(tmp_path), *SMALL_RUN, *flags[2:]]
    with_flag = train(_parser().parse_args(base + ["--run_name", "flag", *flags[:2]]))
    without = train(_parser().parse_args(base + ["--run_name", "plain"]))
    assert with_flag["step"] == without["step"] > 0
    assert with_flag["loss"] == without["loss"] and np.isfinite(with_flag["loss"]).all()


@pytest.mark.parametrize("dataset", ["IBIMS", "TUM", "DIODE", "SINTEL"])
def test_cli_train_on_a_zero_shot_set_raises_type_error(dataset, tmp_path):
    """The zero-shot loaders take no size or seed, so training on one fails
    with TypeError in both packages' train command."""
    from pldepth_torch.cli import main
    from pldepth_tpu.cli import _load_data as j_load_data

    with pytest.raises(TypeError, match="size"):
        main(["train", "--device", "cpu", "--output_dir", str(tmp_path), "--dataset", dataset])
    assert not any(tmp_path.iterdir())  # nothing written
    with pytest.raises(TypeError, match="size"):
        j_load_data(JConfig(dataset=dataset))


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "pldepth_torch.cli", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})


def test_cli_train_weights_load_in_both_packages(tmp_path):
    r = _cli("train", "--device", "cpu", "--model_name", "ff_smoke", "--dataset", "synthetic",
             "--input_size", str(S), "--ds_size", "32", "--batch_size", "4", "--epochs", "1",
             "--ranking_size", "5", "--rankings_per_image", "10", "--compute_dtype", "float32",
             "--output_dir", str(tmp_path), "--run_name", "r")
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    weights = str(tmp_path / "r" / "weights.npz")
    assert out["weights"] == weights and out["step"] == 7  # 30 train samples / 4
    assert len(out["val_loss"]) == 0  # 2 val samples < one batch of 4
    assert (tmp_path / "r" / "metrics.csv").exists()

    from pldepth_tpu.train.checkpoint import load_weights_npz as j_load

    jtr = JTrainer(JConfig(model_name="ff_smoke", input_size=S), steps_per_epoch=1,
                   mesh=make_mesh(devices=jax.devices()[:1]))
    jstate = j_load(weights, jtr.init_state())
    with np.load(weights) as archive:
        for k, v in flat_jax(jstate).items():
            np.testing.assert_array_equal(v, archive[k])

    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (S, S, 3), dtype=np.uint8)).save(imgs / f"{i}.png")
    r = _cli("predict", "--device", "cpu", "--model_name", "ff_smoke", "--load_model_path",
             weights, "--inputs", str(imgs), "--out_dir", str(tmp_path / "d"), "--input_size",
             str(S), "--fused_encoder", "true", "--save_png", "false")
    assert r.returncode == 0, r.stderr
    for i in range(2):
        d = np.load(tmp_path / "d" / f"{i}_depth.npy")
        assert d.shape == (S, S) and np.isfinite(d).all()


def test_fit_stops_on_a_non_finite_epoch():
    """The NaN stop: an epoch whose loss is not finite ends the run after
    that epoch, and the guard kept the weights."""
    cfg, trainer = _tiny(epochs=3)
    good = SyntheticDepthDataset(n=12, image_size=S, seed=0)

    def load(i):
        item = dict(good[i])
        item["image"] = np.full_like(item["image"], np.nan)
        return item

    state = trainer.init_state()
    before = _params(state)
    it = BatchIterator(DepthDataset("nan", 12, load), 4, seed=0)
    state, history = trainer.fit(state, it)
    it.close()
    assert len(history["loss"]) == 1 and not np.isfinite(history["loss"][0])
    assert state.step == 3 and int(state.opt.count) == 0
    assert all(torch.equal(a, b) for a, b in zip(before, _params(state)))


def test_checkpoint_rotation_and_best_val_survive_a_restart(tmp_path):
    cfg, trainer = _tiny()
    state = trainer.init_state()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save(step, state.replace(step=step))
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    assert mgr.maybe_save_best(4, state, 0.5) and not mgr.maybe_save_best(5, state, 0.7)
    again = CheckpointManager(str(tmp_path), keep=2)
    assert again.best_val == 0.5 and again.steps() == [3, 4]
    restored = again.restore(state, step=3)
    assert restored.step == 3 and restored.model is not state.model
    for a, b in zip(state.model.state_dict().values(), restored.model.state_dict().values()):
        assert torch.equal(a, b)


def test_metric_logger_csv_header_grows(tmp_path):
    from pldepth_torch.obs.logging import MetricLogger

    logger = MetricLogger(str(tmp_path), "r", {"a": 1})
    logger.log({"step_loss": 1.0}, step=0)
    logger.log({"loss": 2.0, "val_loss": None}, step=1)
    logger.close()
    lines = (tmp_path / "r" / "metrics.csv").read_text().splitlines()
    assert lines[0].split(",") == ["_time", "step", "step_loss", "loss", "val_loss"]
    assert len(lines) == 3
    assert json.loads((tmp_path / "r" / "config.json").read_text()) == {"a": 1}
    assert len((tmp_path / "r" / "metrics.jsonl").read_text().splitlines()) == 2

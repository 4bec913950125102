"""The port's sweeps (pldepth_torch/sweep) against the JAX package's
(pldepth_tpu/sweep): the same draws (``==``) from ``_sample``, ``_grid`` and
``_sample_tpe`` over every search space and several seeds; with
``run_single`` replaced in both packages by the same deterministic function
of the overrides, byte-equal ``sweep_state.jsonl`` files for random, grid and
TPE searches, fresh, resumed and with the grid exhausted, and the same
records from ``run_wandb_sweep`` against tests/test_wandb_replay.py's
FakeWandb; the same ValueErrors; one real ``run_single`` at ff_smoke 64^2
on the CPU; the analysis helpers equal."""

import json
import math
import os

import numpy as np
import pytest
import torch
from test_wandb_replay import FakeWandb

from pldepth_torch.core.config import ExperimentConfig
from pldepth_torch.sweep import analyze as pan
from pldepth_torch.sweep import sweep as psw
from pldepth_torch.sweep.search_spaces import SEARCH_SPACES
from pldepth_tpu.core.config import ExperimentConfig as JConfig
from pldepth_tpu.sweep import analyze as jan
from pldepth_tpu.sweep import sweep as jsw
from pldepth_tpu.sweep.search_spaces import SEARCH_SPACES as J_SPACES

torch.set_num_threads(1)

SPACES = sorted(J_SPACES)
SEEDS = (0, 1, 7, 123)


def test_search_spaces_equal_jax():
    assert SEARCH_SPACES == J_SPACES
    assert SPACES == ["active", "base", "large_rankings"]


@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("seed", SEEDS)
def test_sample_equals_jax(space, seed):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    got = [psw._sample(SEARCH_SPACES[space], a) for _ in range(16)]
    want = [jsw._sample(J_SPACES[space], b) for _ in range(16)]
    assert got == want
    assert a.bit_generator.state == b.bit_generator.state


@pytest.mark.parametrize("space", SPACES)
def test_grid_equals_jax(space):
    spec = {k: v for k, v in SEARCH_SPACES[space].items() if "values" in v}
    assert list(psw._grid(spec)) == list(jsw._grid(spec))
    if len(spec) < len(SEARCH_SPACES[space]):  # a continuous parameter refuses a grid
        with pytest.raises(ValueError) as got:
            list(psw._grid(SEARCH_SPACES[space]))
        with pytest.raises(ValueError) as want:
            list(jsw._grid(J_SPACES[space]))
        assert str(got.value) == str(want.value)


def _metric(overrides):
    """A deterministic score of a draw; ranking_size 7 fails the run."""
    if overrides.get("ranking_size") == 7:
        raise RuntimeError("ranking_size 7 fails in this test")
    return float(sum((np.log1p(float(v)) - 1.0) ** 2 for v in overrides.values()))


def _history(space, n, seed):
    rng = np.random.default_rng(seed + 1000)
    out = []
    for i in range(n):
        o = jsw._sample(J_SPACES[space], rng)
        m = float("inf") if i % 5 == 4 else _metric({k: v for k, v in o.items()
                                                      if k != "ranking_size"})
        out.append({"overrides": o, "metrics": {"test_error": m}})
    return out


@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_hist", [3, 6, 11])
def test_sample_tpe_equals_jax(space, seed, n_hist):
    hist = _history(space, n_hist, seed)
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    got = [psw._sample_tpe(SEARCH_SPACES[space], hist, "test_error", a) for _ in range(3)]
    want = [jsw._sample_tpe(J_SPACES[space], hist, "test_error", b) for _ in range(3)]
    assert got == want
    assert a.bit_generator.state == b.bit_generator.state


@pytest.fixture
def fake_runs(monkeypatch):
    """run_single in both packages: the same function of the overrides."""
    calls = {"port": [], "jax": []}

    def fake(name):
        def run(cfg, target, device=None):
            keys = SEARCH_SPACES["base"].keys() | SEARCH_SPACES["active"].keys() | {
                "rankings_per_image"}
            o = {k: getattr(cfg, k) for k in sorted(keys)}
            calls[name].append((o, device))
            m = _metric(o)
            return {"loss": m / 2, "test_error": m, **({"whdr": m / 3} if target == "whdr"
                                                        else {})}
        return run

    monkeypatch.setattr(psw, "run_single", fake("port"))
    monkeypatch.setattr(jsw, "run_single", fake("jax"))
    return calls


def _sweep_both(tmp_path, name, resume_at=None, seed=3, **kw):
    out = {}
    for pkg, mod, cfg_cls in (("port", psw, ExperimentConfig), ("jax", jsw, JConfig)):
        cfg = cfg_cls(seed=seed, output_dir=str(tmp_path / pkg / name))
        extra = {"device": "cpu"} if pkg == "port" else {}
        if resume_at is not None:
            mod.run_sweep(cfg, **{**kw, "num_runs": resume_at}, **extra)
        res = mod.run_sweep(cfg, **kw, **extra)
        with open(tmp_path / pkg / name / "sweep_state.jsonl", "rb") as f:
            out[pkg] = (res, f.read())
    return out


@pytest.mark.parametrize("search,space,target,resume_at", [
    ("random", "base", "test_error", None), ("random", "base", "test_error", 3),
    ("random", "large_rankings", "loss", None), ("tpe", "base", "test_error", None),
    ("tpe", "base", "whdr", 5), ("tpe", "active", "test_error", 6),
    ("grid", "discrete", "loss", None), ("grid", "discrete", "test_error", 4),
])
def test_run_sweep_state_files_equal_jax(tmp_path, fake_runs, monkeypatch, search, space,
                                         target, resume_at):
    """(Every registered space has a continuous learning rate, so the grid
    runs over a discrete space registered in both packages.)"""
    discrete = {k: v for k, v in SEARCH_SPACES["base"].items() if "values" in v}
    monkeypatch.setitem(SEARCH_SPACES, "discrete", discrete)
    monkeypatch.setitem(J_SPACES, "discrete", discrete)
    out = _sweep_both(tmp_path, "s", resume_at, num_runs=9, search=search, target=target,
                      space_name=space)
    assert out["port"] == out["jax"]
    res, raw = out["port"]
    lines = raw.decode().splitlines()
    assert len(lines) == res["num_runs"] == 9
    errors = [json.loads(line)["metrics"] for line in lines
              if "error" in json.loads(line)["metrics"]]
    assert all(math.isinf(e[target]) for e in errors)
    assert all(d == torch.device("cpu") for _, d in fake_runs["port"])


def test_grid_exhaustion_equals_jax(tmp_path, fake_runs, monkeypatch):
    space = {"initial_lr": {"values": [0.1, 0.2]}, "lr_multi": {"values": [0.5, 1.0]}}
    monkeypatch.setitem(SEARCH_SPACES, "tiny", space)
    monkeypatch.setitem(J_SPACES, "tiny", space)
    out = _sweep_both(tmp_path, "g", resume_at=3, num_runs=8, search="grid", target="loss",
                      space_name="tiny")
    assert out["port"] == out["jax"]
    assert out["port"][0]["num_runs"] == 4 and out["port"][0]["best"] is not None


@pytest.mark.parametrize("kw", [{"target": "nonsense"}, {"search": "anneal"}])
def test_unknown_target_or_strategy_raises_like_jax(tmp_path, fake_runs, kw):
    with pytest.raises(ValueError) as got:
        psw.run_sweep(ExperimentConfig(output_dir=str(tmp_path / "p")), num_runs=1,
                      device="cpu", **kw)
    with pytest.raises(ValueError) as want:
        jsw.run_sweep(JConfig(output_dir=str(tmp_path / "j")), num_runs=1, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("target", ["test_error", "loss"])
def test_space_to_wandb_equals_jax(space, target):
    assert (psw.space_to_wandb(SEARCH_SPACES[space], target)
            == jsw.space_to_wandb(J_SPACES[space], target))


@pytest.mark.parametrize("sweep_id", [None, "pre-existing"])
def test_run_wandb_sweep_equals_jax(fake_runs, sweep_id):
    out, fakes = {}, {}
    for pkg, mod, cfg_cls in (("port", psw, ExperimentConfig), ("jax", jsw, JConfig)):
        fake = fakes[pkg] = FakeWandb()
        if sweep_id:
            fake.sweeps[sweep_id] = {"config": jsw.space_to_wandb(J_SPACES["active"], "loss"),
                                     "project": "pldepth-tpu-sweep"}
        extra = {"device": "cpu"} if pkg == "port" else {}
        out[pkg] = mod.run_wandb_sweep(cfg_cls(seed=2), num_runs=5, target="test_error",
                                       space_name="base", sweep_id=sweep_id, _wandb=fake,
                                       **extra)
    assert out["port"] == out["jax"]
    assert out["port"]["num_runs"] == 5
    for attr in ("sweeps", "agent_calls", "module_logged"):
        assert getattr(fakes["port"], attr) == getattr(fakes["jax"], attr), attr
    assert [r.config for r in fakes["port"].runs] == [r.config for r in fakes["jax"].runs]
    assert all(r.finished for r in fakes["port"].runs)


def test_run_single_on_the_cpu():
    cfg = ExperimentConfig(model_name="ff_smoke", dataset="synthetic", ds_size=16,
                           input_size=64, batch_size=4, ranking_size=3, rankings_per_image=8,
                           epochs=1, compute_dtype="float32")
    got = psw.run_single(cfg, "whdr", device="cpu")
    assert sorted(got) == ["loss", "test_error", "whdr"]
    assert all(math.isfinite(v) for v in got.values()), got


def _trials(tmp_path):
    recs = [{"overrides": {"initial_lr": 0.01, "ranking_size": 5},
             "metrics": {"test_error": 0.31, "loss": 1.0}},
            {"overrides": {"initial_lr": 0.0004, "ranking_size": 25},
             "metrics": {"test_error": float("nan"), "loss": 2.0}},
            {"overrides": {"initial_lr": 0.2, "ranking_size": 3},
             "metrics": {"test_error": 0.27, "loss": 3.0}},
            {"overrides": {"initial_lr": 0.05, "ranking_size": 10},
             "metrics": {"test_error": float("inf"), "error": "boom"}}]
    path = tmp_path / "sweep_state.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs) + "\n")
    return str(path)


@pytest.mark.parametrize("target", ["test_error", "loss"])
def test_analysis_equals_jax(tmp_path, target):
    path = _trials(tmp_path)
    trials = pan.load_trials(path)
    assert json.dumps(trials) == json.dumps(jan.load_trials(path))
    assert pan.best_trial(trials, target) == jan.best_trial(trials, target)
    assert pan.param_table(trials, target) == jan.param_table(trials, target)
    got = pan.plot_param_vs_metric(path, str(tmp_path / "p"), target)
    want = jan.plot_param_vs_metric(path, str(tmp_path / "j"), target)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == [
        f"initial_lr_vs_{target}.png", f"ranking_size_vs_{target}.png"]
    assert all(os.path.getsize(p) > 0 for p in got)

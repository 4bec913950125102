"""The port's command line against the JAX package's click group: each of
its thirteen commands is a port subcommand carrying every JAX option under
the same flag, default and required-ness; the port adds ``--device`` to the
commands that run the model and differs by name only where listed here.
Then ``sweep``, ``analyze``, ``warmup`` and ``train --profile true`` run
on the CPU at ff_smoke 64^2."""

import argparse
import contextlib
import glob
import io
import json
import math
import os
import sys

import pytest
import torch
from test_wandb_replay import FakeWandb

from pldepth_torch import cli
from pldepth_tpu.cli import cli as jcli

torch.set_num_threads(1)

JAX_COMMANDS = sorted(jcli.commands)
# options the port adds, by command: where the model runs ("cuda" unless
# the CPU is asked for); analyze and convert run on the host only
# predict adds a profiled serving loop
PORT_ADDITIONS = {c: {"device"} for c in JAX_COMMANDS if c not in ("analyze", "convert")}
PORT_ADDITIONS["predict"] = {"device", "profile_dir"}
# (command, option) -> (port default, JAX default): the artifact's platform
# list names the port's devices
DIFFERENCES = {("export", "platforms"): ("cuda,cpu", "tpu,cpu")}


def _subparsers():
    p = cli._parser()
    sub = next(a for a in p._actions if isinstance(a, argparse._SubParsersAction))
    return sub.choices


def test_every_jax_command_is_a_port_subcommand():
    assert JAX_COMMANDS == ["active", "analyze", "chi2", "convert", "dump", "eval", "export",
                            "predict", "serve", "sweep", "train", "warmup", "zeroshot"]
    assert sorted(_subparsers()) == JAX_COMMANDS


@pytest.mark.parametrize("command", JAX_COMMANDS)
def test_options_match_jax(command):
    port = {a.dest: a for a in _subparsers()[command]._actions if a.option_strings
            and a.dest != "help"}
    for prm in jcli.commands[command].params:
        a = port.get(prm.name)
        assert a is not None, f"{command}: no {prm.opts[0]}"
        assert a.option_strings == list(prm.opts), prm.name
        assert a.required == prm.required, prm.name
        if prm.required:
            continue
        want = DIFFERENCES.get((command, prm.name), (prm.default, prm.default))
        assert (a.default, prm.default) == want, prm.name
        if getattr(prm, "is_flag", False):
            assert a.nargs == 0 and a.const is True, prm.name  # store_true
    extra = set(port) - {p.name for p in jcli.commands[command].params}
    assert extra == PORT_ADDITIONS.get(command, set())


def _run(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(list(argv)) == 0
    out = buf.getvalue().strip().splitlines()
    start = max(i for i, line in enumerate(out) if line.startswith("{"))
    return json.loads("\n".join(out[start:]))


SMOKE = ("--model_name", "ff_smoke", "--input_size", "64", "--compute_dtype", "float32")


def test_cli_sweep_then_analyze_on_the_cpu(tmp_path):
    """Two random large-list runs (K up to 500) recorded and resumed to
    three; analyze names the least test_error and plots each parameter."""
    args = ("sweep", "--device", "cpu", *SMOKE, "--ds_size", "16", "--epochs", "1",
            "--search", "random", "--space", "large_rankings", "--output_dir", str(tmp_path))
    out = _run(*args, "--num_runs", "2")
    state = tmp_path / "sweep_state.jsonl"
    first = state.read_bytes()
    out = _run(*args, "--num_runs", "3")
    assert out["num_runs"] == 3 and state.read_bytes().startswith(first)
    recs = [json.loads(line) for line in state.read_text().splitlines()]
    assert len(recs) == 3
    for r in recs:
        assert "error" not in r["metrics"]
        assert all(math.isfinite(v) for v in r["metrics"].values())
    best = min(recs, key=lambda r: r["metrics"]["test_error"])
    assert out["best"] == best
    rep = _run("analyze", "--state_path", str(state), "--out_dir", str(tmp_path / "plots"))
    assert rep["best"] == best
    assert sorted(os.path.basename(p) for p in rep["plots"]) == [
        "initial_lr_vs_test_error.png", "ranking_size_vs_test_error.png",
        "rankings_per_image_vs_test_error.png"]


def test_cli_sweep_wandb_backend(tmp_path, monkeypatch):
    from pldepth_torch.sweep import sweep as sw

    fake = FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    monkeypatch.setattr(sw, "run_single", lambda cfg, target, device=None: {
        "loss": cfg.initial_lr, "test_error": cfg.initial_lr})
    out = _run("sweep", "--device", "cpu", *SMOKE, "--search", "wandb", "--num_runs", "3",
               "--space", "active", "--output_dir", str(tmp_path))
    assert out["sweep_id"] == "fake-sweep-0" and out["num_runs"] == 3
    assert fake.agent_calls == [{"sweep_id": "fake-sweep-0", "count": 3,
                                 "project": "pldepth-tpu-sweep"}]
    assert out["best"]["metrics"]["test_error"] == min(
        m["test_error"] for m, _ in fake.module_logged)


def test_cli_warmup_on_the_cpu(tmp_path, monkeypatch):
    """A cold build directory: the packed reader is built (no nvcc use on
    the CPU), then every graph of the config runs once; a second call
    builds nothing."""
    from pldepth_torch.data import packed
    from pldepth_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(packed, "BUILD_DIR", tmp_path / "build")
    args = ("warmup", "--device", "cpu", *SMOKE, "--batch_size", "2", "--serve_batch", "3",
            "--data_resident", "true", "--resident_chain_steps", "2")
    out = _run(*args)
    assert sorted(out) == ["build_s", "built", "cache_dir", "predict_bnfold_s", "predict_s",
                           "resident_s", "train_step_s"]
    assert out["built"] == ["packio"] and out["cache_dir"] == str(tmp_path / "build")
    assert all(out[k] >= 0 for k in out if k.endswith("_s"))
    assert [p.name.split("-")[0] for p in (tmp_path / "build").iterdir()] == ["packio"]
    again = _run("warmup", "--device", "cpu", *SMOKE, "--batch_size", "2")
    assert again["built"] == [] and sorted(again) == ["build_s", "built", "cache_dir",
                                                      "train_step_s"]


def test_cli_train_profile_on_the_cpu(tmp_path):
    """--profile true: a Chrome trace of three steady steps of ``fit``
    under <run>/profile, with the program's spans (the steps' phases, the
    feed, the epoch's readback where an epoch ends inside), TensorBoard
    scalars under <run>/tb, weights saved."""
    out = _run("train", "--device", "cpu", *SMOKE, "--dataset", "synthetic", "--ds_size", "24",
               "--batch_size", "8", "--epochs", "2", "--ranking_size", "3",
               "--rankings_per_image", "10", "--output_dir", str(tmp_path), "--run_name", "p",
               "--profile", "true", "--use_tensorboard", "true")
    run = tmp_path / "p"
    assert out["step"] == 2 * ((24 - 24 // 15) // 8) and os.path.exists(out["weights"])
    (trace,) = glob.glob(str(run / "profile" / "*.pt.trace.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events]
    assert names.count("aten::sort") >= 3  # the rankings' label sort, each step
    # the program's spans of steps 1-3 (the first step is outside); on the
    # CPU no step has an event for fit to wait on, and one process has no
    # stop agreement
    spans = [e for e in events if e.get("cat") == "program_span"]
    assert [e["args"]["ident"] for e in spans if e["name"] == "step"] == [1, 2, 3]
    assert {e["name"] for e in spans} == {"step", "step.upload", "step.sample", "step.forward",
                                          "step.backward", "step.update", "fit.feed",
                                          "fit.epoch"}
    assert [e["args"]["ident"] for e in spans if e["name"] == "fit.feed"] == [2, 3, 4]
    assert [e["args"]["ident"] for e in spans if e["name"] == "fit.epoch"] == [2]
    assert glob.glob(str(run / "tb" / "events.*"))
    epochs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in epochs if "loss" in r] == [0, 1]

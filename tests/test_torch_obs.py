"""The port's run logging and profiling (pldepth_torch/obs) against the JAX
package's (pldepth_tpu/obs): the same calls on both MetricLoggers give
byte-equal local files (the clock pinned, so ``_time`` agrees too), the same
TensorBoard scalars and images read back from the event files, and the same
calls into stub ``wandb`` and ``mlflow`` modules; a sink whose package is
missing leaves the logger local-only with a warning in both packages;
``profile_trace`` writes a Chrome trace that holds a step's ops and
``step_timer`` reports under the JAX key."""

import glob
import inspect
import json
import logging
import os
import sys
import types

import numpy as np
import pytest
import torch

from pldepth_torch.obs import logging as plog
from pldepth_torch.obs import profiling as pprof
from pldepth_tpu.obs import logging as jlog
from pldepth_tpu.obs import profiling as jprof

torch.set_num_threads(1)

CONFIG = {"model_name": "ff_smoke", "initial_lr": 0.01, "ranking_size": 5, "mesh": {"data": -1}}


def _images():
    rng = np.random.default_rng(0)
    return {"ex_img": rng.uniform(size=(12, 10, 3)).astype(np.float32),
            "ex_gt": rng.uniform(0.1, 2.0, (12, 10)).astype(np.float32),
            "ex_pred": np.zeros((12, 10, 1), np.float32)}


CAPTIONS = {"ex_img": "input image", "ex_gt": "input ground truth"}


def _drive(module, out, run="r", **kw):
    """The calls cli train makes on its logger: per-step rows, epoch rows
    whose keys grow the CSV, a summary, example images, close."""
    lg = module.MetricLogger(str(out), run, CONFIG, **kw)
    for step in range(3):
        lg.log({"step_loss": 1.0 / (step + 1), "step_lr": 0.01}, step=step)
    lg.log({"loss": 0.5, "val_loss": None, "lr": 0.005, "images_per_sec": 12.5}, step=0)
    lg.log({"loss": 0.25, "val_loss": 0.3, "lr": 0.0025, "images_per_sec": 13.0,
            "note": "text"}, step=1)
    lg.set_summary(test_error=0.2, ndcg_200=0.9)
    lg.set_summary(tag="x")
    lg.log_images(_images(), captions=CAPTIONS)
    lg.close()
    return lg


@pytest.fixture
def pinned_clock(monkeypatch):
    for mod in (plog, jlog):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(time=lambda: 1792236659.25))


def _files(run_dir):
    out = {}
    for path in sorted(glob.glob(os.path.join(run_dir, "**", "*"), recursive=True)):
        if os.path.isfile(path) and "/tb/" not in path:
            with open(path, "rb") as f:
                out[os.path.relpath(path, run_dir)] = f.read()
    return out


@pytest.mark.parametrize("sessions", [1, 2])
def test_local_files_equal_jax(tmp_path, pinned_clock, sessions):
    """metrics.jsonl, metrics.csv (a header that grows, and adopted on a
    second session as --resume does), config.json, summary.json and the
    example PNGs are byte-equal."""
    for _ in range(sessions):
        _drive(plog, tmp_path / "port")
        _drive(jlog, tmp_path / "jax")
    got, want = _files(tmp_path / "port" / "r"), _files(tmp_path / "jax" / "r")
    assert sorted(got) == sorted(want) == [
        "config.json", "examples/ex_gt.png", "examples/ex_img.png", "examples/ex_pred.png",
        "metrics.csv", "metrics.jsonl", "summary.json"]
    for name in want:
        assert got[name] == want[name], name
    assert got["metrics.jsonl"].count(b"\n") == 5 * sessions


def test_signatures_equal_jax():
    for fn in ("__init__", "log", "set_summary", "log_images", "close"):
        assert (inspect.signature(getattr(plog.MetricLogger, fn))
                == inspect.signature(getattr(jlog.MetricLogger, fn))), fn


def _tb_read(run_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    (events,) = glob.glob(os.path.join(run_dir, "tb", "events.*"))
    acc = EventAccumulator(events, size_guidance={"scalars": 0, "images": 0})
    acc.Reload()
    tags = acc.Tags()
    scalars = {t: [(e.step, e.value) for e in acc.Scalars(t)] for t in tags["scalars"]}
    images = {t: [(e.step, e.width, e.height, e.encoded_image_string) for e in acc.Images(t)]
              for t in tags["images"]}
    return scalars, images


def test_tensorboard_scalars_and_images_equal_jax(tmp_path):
    _drive(plog, tmp_path / "port", use_tensorboard=True)
    _drive(jlog, tmp_path / "jax", use_tensorboard=True)
    got, want = _tb_read(tmp_path / "port" / "r"), _tb_read(tmp_path / "jax" / "r")
    assert got == want
    scalars, images = got
    assert scalars["step_loss"] == [(0, 1.0), (1, 0.5), (2, pytest.approx(1 / 3))]
    assert scalars["summary/test_error"] == [(0, pytest.approx(0.2))]
    assert "val_loss" in scalars and "note" not in scalars
    assert sorted(images) == ["ex_gt", "ex_img", "ex_pred"]


class _WandbRun:
    def __init__(self, calls, **kw):
        self.calls = calls
        self.summary = _Summary(calls)
        calls.append(("init", kw))

    def log(self, metrics, step=None):
        self.calls.append(("log", {k: (v.array.tolist(), v.caption) if hasattr(v, "caption")
                                   else v for k, v in metrics.items()}, step))

    def finish(self):
        self.calls.append(("finish",))


class _Summary(dict):
    def __init__(self, calls):
        super().__init__()
        self.calls = calls

    def __setitem__(self, k, v):
        self.calls.append(("summary", k, v))
        super().__setitem__(k, v)


def _wandb_stub(calls):
    stub = types.ModuleType("wandb")
    stub.init = lambda **kw: _WandbRun(calls, **kw)

    class Image:
        def __init__(self, array, caption=None):
            self.array, self.caption = np.asarray(array), caption

    stub.Image = Image
    return stub


def _mlflow_stub(calls):
    stub = types.ModuleType("mlflow")
    stub.set_tracking_uri = lambda u: calls.append(("uri", u))
    stub.start_run = lambda run_name=None: calls.append(("start", run_name))
    stub.log_params = lambda p: calls.append(("params", dict(p)))
    stub.log_metrics = lambda m, step=None: calls.append(("metrics", dict(m), step))
    stub.end_run = lambda: calls.append(("end",))
    return stub


@pytest.mark.parametrize("sink", ["wandb", "mlflow"])
def test_stub_sinks_record_the_same_calls(tmp_path, monkeypatch, sink):
    kw = ({"use_wandb": True, "wandb_project": "proj"} if sink == "wandb" else
          {"use_mlflow": True, "mlflow_tracking_uri": "file:/tmp/mlruns"})
    stub = _wandb_stub if sink == "wandb" else _mlflow_stub
    recorded = {}
    for name, module in (("port", plog), ("jax", jlog)):
        calls = recorded[name] = []
        monkeypatch.setitem(sys.modules, sink, stub(calls))
        _drive(module, tmp_path / name, **kw)
    assert recorded["port"] == recorded["jax"]
    calls = recorded["port"]
    if sink == "wandb":
        assert calls[0] == ("init", {"project": "proj", "name": "r", "config": CONFIG})
        assert ("summary", "test_error", 0.2) in calls
        images = [c[1] for c in calls if c[0] == "log" and "ex_gt" in c[1]]
        assert images[0]["ex_gt"][1] == "input ground truth"
    else:
        assert calls[:2] == [("uri", "file:/tmp/mlruns"), ("start", "r")]
        assert ("metrics", {"summary_test_error": 0.2, "summary_ndcg_200": 0.9}, None) in calls
    assert calls[-1] in (("finish",), ("end",))


@pytest.mark.parametrize("sink", ["wandb", "mlflow"])
def test_missing_sink_leaves_the_logger_local_only(tmp_path, monkeypatch, caplog, sink):
    """Neither package is installed here: both loggers warn and keep their
    local files."""
    monkeypatch.setitem(sys.modules, sink, None)  # import raises ImportError
    for name, module in (("port", plog), ("jax", jlog)):
        with caplog.at_level(logging.WARNING):
            lg = _drive(module, tmp_path / name, **{f"use_{sink}": True})
        assert getattr(lg, f"_{sink}") is None
        assert f"{sink} requested but unavailable" in caplog.text
        caplog.clear()
    assert _files(tmp_path / "port" / "r").keys() == _files(tmp_path / "jax" / "r").keys()


def test_profile_trace_holds_a_steps_ops(tmp_path):
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.train import Trainer

    tr = Trainer(ExperimentConfig(model_name="ff_smoke", input_size=32, batch_size=2,
                                  ranking_size=3, rankings_per_image=8), device="cpu")
    state = tr.init_state()
    rng = np.random.default_rng(0)
    batch = {"image": rng.uniform(size=(2, 32, 32, 3)).astype(np.float32),
             "gt": rng.uniform(0.1, 1, (2, 32, 32)).astype(np.float32),
             "mask": np.ones((2, 32, 32), np.float32)}
    state, _ = tr.train_step(state, batch)
    with pprof.profile_trace(str(tmp_path / "profile")):
        tr.train_step(state, batch)
    (path,) = glob.glob(str(tmp_path / "profile" / "*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"aten::convolution", "aten::sort"} <= names
    assert any("backward" in str(n).lower() for n in names)


def test_step_timer_reports_under_the_jax_key():
    got, want = [], []
    with pprof.step_timer(got.append, "train"):
        torch.ones(4).sum()
    with jprof.step_timer(want.append, "train"):
        pass
    assert [list(d) for d in got] == [list(d) for d in want] == [["train_time_s"]]
    assert got[0]["train_time_s"] >= 0

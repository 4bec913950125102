"""The port's quant metric gate (pldepth_torch/tools/quant_metric_gate.py).

Its budget is the JAX tool's (tools/quant_metric_gate.py, loaded by path);
its summary arithmetic is held to rows computed by hand: NaN pairs left
out, a directional verdict (an int8 result better than float passes at any
size), an advisory metric that never gates, a metric with no valid image;
and ``run_gate`` runs end to end on the CPU at ``ff_smoke`` 64^2 (one epoch
of two chains of 8 steps, 8 images), from ``train`` and from a weights.npz,
returning the JAX result's keys; and the port's ``run_gate`` and the JAX
tool's, on one weights.npz at ``ff_smoke`` 64^2 in f32, give the same
metrics dict.
"""

import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

from pldepth_torch.tools import quant_metric_gate as gate

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULT_KEYS = {"model", "size", "n_images", "dataset", "weights", "metrics", "pass"}
ROW_KEYS = {"float", "int8", "delta", "quality_loss", "budget", "delta_abs_p95", "n_valid",
            "pass"}


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "quant_metric_gate", os.path.join(REPO, "tools", "quant_metric_gate.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_budget_and_advisory_equal_the_jax_tool():
    tool = _jax_tool()
    assert gate.BUDGET == tool.BUDGET
    assert gate.ADVISORY == tool.ADVISORY


def _row(o, w, n, eb, ec):
    return {"ordinal_error": o, "whdr_003": w, "ndcg_200": n, "edge_boundary": eb,
            "edge_completeness": ec}


NAN = float("nan")
ROWS = {
    "float": [_row(0.30, 0.40, 0.90, 0.50, NAN), _row(0.20, 0.30, 0.80, NAN, NAN),
              _row(0.10, 0.20, 0.70, 0.70, NAN)],
    "int8": [_row(0.31, 0.38, 0.80, 0.40, NAN), _row(0.20, 0.30, 0.90, 0.60, NAN),
             _row(0.11, 0.20, 0.60, 0.60, 0.10)],
}


def test_summary_by_hand():
    m = gate.summarize(ROWS)
    assert set(m) == set(gate.BUDGET) | set(gate.ADVISORY)
    # ordinal error: (+0.01 + 0 + 0.01) / 3 -> a loss of 0.00667 > 0.002
    o = m["ordinal_error"]
    assert set(o) == ROW_KEYS
    assert (o["float"], o["int8"], o["n_valid"]) == (0.2, 0.20667, 3)
    assert o["delta"] == o["quality_loss"] == 0.00667 and o["pass"] is False
    assert o["delta_abs_p95"] == round(float(np.percentile([0.01, 0.0, 0.01], 95)), 5)
    # WHDR: int8 better (-0.02 / 3): passes at any size
    w = m["whdr_003"]
    assert w["delta"] == -0.00667 and w["quality_loss"] == -0.00667 and w["pass"] is True
    # edge boundary: higher is better; image 2 is a NaN pair and is left out
    eb = m["edge_boundary"]
    assert eb["n_valid"] == 2 and (eb["float"], eb["int8"]) == (0.6, 0.5)
    assert eb["quality_loss"] == 0.1 and eb["pass"] is False
    # edge completeness: no image valid on both sides
    assert m["edge_completeness"] == {"n_valid": 0, "pass": True, "note": "no valid images"}
    # NDCG@200 fails its budget (-0.2 / 3 on a higher-is-better metric) but is advisory
    nd = m["ndcg_200"]
    assert nd["advisory"] is True and nd["pass"] is False
    assert gate.verdict({"ndcg_200": nd, "edge_completeness": m["edge_completeness"]})
    assert not gate.verdict(m)
    assert gate.verdict({k: v for k, v in m.items() if k in ("whdr_003", "ndcg_200")})


def test_summary_passes_inside_the_budget():
    rows = {"float": [_row(0.2, 0.2, 0.9, 0.5, 0.5)] * 4,
            "int8": [_row(0.2015, 0.2019, 0.9, 0.49, 0.485)] * 4}
    m = gate.summarize(rows)
    assert all(v["pass"] for v in m.values()) and gate.verdict(m)
    assert m["edge_completeness"]["quality_loss"] == pytest.approx(0.015)


def test_run_gate_end_to_end_on_the_cpu(tmp_path, capsys):
    wpath = str(tmp_path / "w.npz")
    res = gate.run_gate(model="ff_smoke", size=64, n=9, batch=4, train_epochs=1,
                        save_weights=wpath, device="cpu")
    assert set(res) == RESULT_KEYS and res["n_images"] == 8
    assert (res["model"], res["size"], res["dataset"], res["weights"]) == (
        "ff_smoke", 64, "scenes", "train")
    assert set(res["metrics"]) == set(gate.BUDGET) | set(gate.ADVISORY)
    for name in ("ordinal_error", "whdr_003"):
        row = res["metrics"][name]
        assert set(row) == ROW_KEYS and row["n_valid"] == 8 and math.isfinite(row["delta"])
    assert res["pass"] == gate.verdict(res["metrics"])
    out = capsys.readouterr().out
    assert "# train chain 0: loss" in out and "# train chain 1: loss" in out
    out_json = str(tmp_path / "r.json")
    again = gate.main([wpath, "--model", "ff_smoke", "--size", "64", "--n", "8", "--batch", "4",
                       "--device", "cpu", "--out", out_json])
    assert json.load(open(out_json)) == again and again["weights"] == wpath
    assert set(again) == RESULT_KEYS


def _f32(config_module, monkeypatch):
    """``config_module.ExperimentConfig`` made with f32 compute unless told
    otherwise: both gates build their config inside ``run_gate``, at the
    package default bf16, whose rounding differs between the packages."""
    real = config_module.ExperimentConfig

    def make(**kw):
        kw.setdefault("compute_dtype", "float32")
        return real(**kw)

    monkeypatch.setattr(config_module, "ExperimentConfig", make)


def test_run_gate_matches_the_jax_tool(tmp_path, monkeypatch):
    """The protocol against the JAX tool on the same weights.npz (trained
    one epoch by the port): the evaluation and calibration sets, the batch
    trim (n 9 -> 8), which graph is float, the images left out of the edge
    rows (here one has no edges, so edge_boundary has 7) and the summary. At
    f32 the two packages' graphs agree to rounding, so every
    mean, delta and p95 agrees within 2e-5 (two units of the result's fifth
    decimal) and n_valid and pass are equal."""
    import pldepth_torch.core.config as port_config
    import pldepth_tpu.core.config as jax_config

    _f32(port_config, monkeypatch)
    _f32(jax_config, monkeypatch)
    wpath = str(tmp_path / "w.npz")
    gate.run_gate(model="ff_smoke", size=64, n=8, batch=8, train_epochs=1,
                  save_weights=wpath, device="cpu")
    kw = dict(model="ff_smoke", size=64, n=9, batch=8, weights=wpath)
    want = _jax_tool().run_gate(**kw)
    got = gate.run_gate(**kw, device="cpu")
    assert set(got) == set(want) and got["n_images"] == want["n_images"] == 8
    assert got["pass"] == want["pass"]
    assert set(got["metrics"]) == set(want["metrics"])
    for name, w in want["metrics"].items():
        g = got["metrics"][name]
        assert set(g) == set(w), name
        for key, value in w.items():
            if isinstance(value, float) and key != "budget":
                assert abs(g[key] - value) <= 2e-5, (name, key, g, w)
            else:
                assert g[key] == value, (name, key, g, w)

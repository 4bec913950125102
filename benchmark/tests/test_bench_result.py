"""The last line's fields and the per-layer readers on a made-up run."""

import json

import pytest
import torch

from benchmark.harness import check, manifest, result


def _train_out():
    return {"kind": "train", "feed": "host", "setup_s": 12.5, "window_s": 10.0, "steps": 50,
            "images": 1600, "global_batch": 32, "peak_bytes": 12_300_000_000, "attempted": 50,
            "spans": {"step.issue": [0.02] * 50, "feed.next": [0.001] * 50},
            "trace": {"window_s": 2.0, "busy_s": 1.5, "steps": 10,
                      "ops": {"void k1_fwd_thread_kernel<5, 1>()": (40e-6, 10),
                              "void k1_bwd_thread_kernel<5, 1>()": (30e-6, 10),
                              "ncclDevKernel_AllReduce_Sum_f32_RING_LL": (0.2, 300),
                              "elementwise": (1.2, 5000)},
                      "breakdown": {"device_ops": [["elementwise", 1.2]],
                                    "idle_gaps": [["aten::to", 0.4]]}},
            "costs": {"train_ops_per_step": 1.6e12, "k1_least_s_per_step": 0.18e-6},
            "numbers": {"loss": 1e-3, "grad": 0.05, "change": 0.01, "leaves": 0.0},
            "check_s": 3.0, "losses": [5.0], "ref_losses": [5.0]}


@pytest.fixture
def effnet_cell():
    return manifest.cell("effnet448-train-b32")


@pytest.mark.parametrize("traced", [False, True])
def test_line_fields(effnet_cell, traced, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    line = result.assemble(effnet_cell, _train_out(), {"import": 1.0}, traced, 1, 0)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    want = {m["name"] for m in (effnet_cell["per_layer"] if traced else
                                effnet_cell["end_to_end"])}
    assert set(line["metrics"]) <= want
    if not traced:
        assert set(line["metrics"]) == want
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert ("busy_s" in line["device"]) == traced and ("breakdown" in line) == traced
    result.emit(line)
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert list(last)[-1] == "checks"
    assert all(set(v) == {"value", "limit"} for v in last["checks"].values())
    assert set(last["checks"]) == set(effnet_cell["limits"])
    assert err.strip().splitlines()[-1].startswith("check ")


def test_readers_on_a_run(effnet_cell):
    run = result.run_context(_train_out(), [_train_out()], 1)
    got = manifest.read_all(effnet_cell["end_to_end"] + effnet_cell["per_layer"], run)
    assert got["hostfed_img_per_s"]["value"] == pytest.approx(160.0)
    assert got["setup_s"]["value"] == 12.5
    assert got["step.issue_ms.host"]["value"] == pytest.approx(20.0)
    assert got["feed.wait_ms.host"]["value"] == pytest.approx(1.0)
    assert got["idle.host"]["value"] == pytest.approx(25.0)
    assert got["peak_gb.host"]["value"] == pytest.approx(12.3)
    assert got["mfu.host"]["value"] == pytest.approx(1.6e12 * 50 / 10.0 / 989e12 * 100)
    assert got["k1_roofline.host"]["value"] == pytest.approx(0.18e-6 * 10 / 70e-6 * 100)


RATES = ("hostfed_img_per_s", "train_img_per_s", "dp_img_per_s", "serve_img_per_s")


@pytest.mark.parametrize("workload, rate", [("effnet448-train-b32", "hostfed_img_per_s"),
                                            ("redweb448-train-b32", "train_img_per_s"),
                                            ("effnetb4-640-train-dp4-g128", "dp_img_per_s"),
                                            ("effnet448-serve-int8-b32", "serve_img_per_s")])
def test_the_feed_picks_the_rate(workload, rate):
    """BENCHMARK.json's lists, not the readers, say which rate a cell reports."""
    listed = {m["name"] for m in manifest.cell(workload)["end_to_end"]}
    assert listed & set(RATES) == {rate}


def test_dp_readers_need_ranks():
    run = result.run_context(_train_out(), [_train_out()] * 4, 4)
    got = manifest.read_all(manifest.cell("effnetb4-640-train-dp4-g128")["per_layer"], run)
    assert got["nccl_ms.dp"]["value"] == pytest.approx(0.2 / 10 * 1e3)
    assert got["nccl_calls.dp"]["value"] == pytest.approx(30.0)
    assert got["mfu.dp"]["value"] == pytest.approx(1.6e12 * 50 / 10.0 / (4 * 989e12) * 100)


def test_a_listed_metric_that_reads_nothing_fails_the_run(effnet_cell):
    run = result.run_context(dict(_train_out(), trace=None), [_train_out()], 1)
    with pytest.raises(manifest.MissingMetric) as e:
        manifest.read_all(effnet_cell["per_layer"], run)
    assert "idle.host" in e.value.names and "k1_roofline.host" in e.value.names
    assert "peak_gb.host" not in e.value.names


def test_judge_needs_every_number_within_its_limit():
    assert check.judge({"a": 1.0, "b": 0.0}, {"a": 1.0, "b": 0.0})
    assert not check.judge({"a": 1.01}, {"a": 1.0})
    assert not check.judge({"a": float("nan")}, {"a": 1.0})
    assert not check.judge({"c": 0.0}, {"a": 1.0})
    assert check.judge({"a": 0.5, "c": 9.0}, {"a": 1.0})  # c is read, not compared


def test_trace_busy_gaps_and_labels():
    from benchmark.harness import trace

    dev = [("k1", 0, 10), ("k2", 5, 10), ("k3", 40, 10)]
    host = [("outer", 0, 100), ("cudaLaunchKernel", 12, 2), ("cudaMemcpyAsync", 25, 20)]
    got = trace.summarize(dev, host, 60e-6)
    assert got["busy_s"] == pytest.approx(25e-6)  # [0, 15] and [40, 50]
    assert got["breakdown"]["idle_gaps"] == [["cudaMemcpyAsync", pytest.approx(25e-6)]]
    assert trace.device_seconds(got, r"k[12]") == (pytest.approx(20e-6), 2)

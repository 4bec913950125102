"""BENCHMARK.json against the benchmark's contract, and every file a cell,
a mix or a metric needs found by its name."""

import json
import re

import pytest

from benchmark.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(json.dumps(bench)) <= 64 * 1024


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names)
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and c["name"] in used
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        body = json.load(open(manifest.ROOT / c["file"]))
        assert body["reduced"] == c["reduced"]
        assert not any(k.endswith(("_dim", "_rank", "_size", "_ch")) for k in c["reduced"])


def test_workloads(bench):
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)


def test_metrics(bench):
    e2e, layer = bench["end_to_end"], bench["per_layer"]
    names = [m["name"] for m in e2e + layer]
    assert len(set(names)) == len(names)
    assert "setup_s" in {m["name"] for m in e2e}
    cells = {w["name"] for w in bench["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in {e["name"] for e in e2e}
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
        assert set(m.get("workloads", cells)) <= cells
    # every per-layer metric's cells report the end-to-end metric it moves
    for m in layer:
        moved = {e["name"]: e for e in e2e}[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    # every cell: setup_s, another end-to-end metric and a per-layer one
    for c in cells:
        rep = [m for m in e2e if c in m.get("workloads", cells)]
        assert len(rep) >= 2
        assert any(c in m.get("workloads", cells) for m in layer)


def test_rooflines_and_mfu_named(bench):
    for m in bench["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")


@pytest.mark.parametrize("kind", ["config", "traffic", "limits", "readers"])
def test_files_found_by_name(bench, kind):
    for w in bench["workloads"]:
        cell = manifest.cell(w["name"])
        if kind == "config":
            assert cell["config"]["model_name"]
        elif kind == "traffic":
            assert cell["traffic"]["kind"] in ("train", "serve")
        elif kind == "limits":
            assert cell["limits"] and all(v >= 0 for v in cell["limits"].values())
        else:
            for m in cell["end_to_end"] + cell["per_layer"]:
                assert callable(manifest.reader(m["name"]))


@pytest.mark.parametrize("metric, found", [("idle.train", "idle.py"),
                                           ("serve.issue_ms.serve", "serve.issue_ms.py"),
                                           ("mfu.dp", "mfu.py"), ("mfu.serve", "mfu.serve.py"),
                                           ("setup_s", "setup_s.py")])
def test_reader_found_by_the_longest_part_of_the_name(metric, found):
    assert manifest.reader_path(metric).name == found


def test_a_metric_without_a_reader_is_an_error():
    with pytest.raises(FileNotFoundError):
        manifest.reader_path("no_such_metric.train")


def test_reader_gives_nothing_without_its_source():
    empty = {"kind": "train", "world": 1, "spans": {}, "trace": None}
    for m in ("feed.wait_ms.host", "k1_roofline.train", "idle.train", "nccl_ms.dp"):
        assert manifest.reader(m)(empty) is None

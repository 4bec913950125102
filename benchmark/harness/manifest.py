"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, a configuration's file (named there), a traffic mix in
``benchmark/traffic/<traffic>.json``, a cell's limits in
``benchmark/limits/<workload>.json``, a metric's reader in
``benchmark/metrics/`` (``reader_path``). A new cell, mix or metric is new files
and new entries; no code here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, root: Path = ROOT) -> dict:
    """Everything a run of workload ``name`` needs: its entry, its
    configuration, traffic and limits, and the metrics it reports."""
    bench = load(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(work)})")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def reports(m: dict) -> bool:
        return name in m["workloads"] if "workloads" in m else True

    return {
        "workload": w,
        "config": _json(root / cfg_entry["file"]),
        "traffic": _json(root / "benchmark" / "traffic" / f"{w['traffic']}.json"),
        "limits": _json(root / "benchmark" / "limits" / f"{name}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
    }


def reader_path(metric: str, root: Path = ROOT) -> Path:
    """The reader of ``metric``: ``benchmark/metrics/<metric>.py``, or else
    that of the longest leading part of the name cut at a dot, so that one
    reader serves a quantity that several cells report under suffixes of
    their own (``idle.py`` reads ``idle.train`` and ``idle.dp``). Which
    cells report a metric is BENCHMARK.json's to say, not the reader's."""
    parts = metric.split(".")
    for n in range(len(parts), 0, -1):
        path = root / "benchmark" / "metrics" / (".".join(parts[:n]) + ".py")
        if path.is_file():
            return path
    raise FileNotFoundError(f"no reader for metric {metric!r} under benchmark/metrics/")


def reader(metric: str, root: Path = ROOT) -> Callable[[dict], object]:
    """The ``read(run)`` function of the metric's reader."""
    path = reader_path(metric, root)
    spec = importlib.util.spec_from_file_location(f"bench_metric_{path.stem.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_all(metrics, run: dict, root: Path = ROOT) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every metric in ``metrics`` (those that
    BENCHMARK.json lists for the cell). A reader that finds nothing to
    read returns None; for a metric listed for the cell that is a fault of
    the run, and raises."""
    out, missing = {}, []
    for m in metrics:
        v = reader(m["name"], root)(run)
        if v is None:
            missing.append(m["name"])
        else:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if missing:
        raise MissingMetric(missing)
    return out


class MissingMetric(RuntimeError):
    """Metrics listed for the cell that the run gave nothing to read."""

    def __init__(self, names):
        super().__init__(f"listed for this cell, read nothing: {', '.join(names)}")
        self.names = names

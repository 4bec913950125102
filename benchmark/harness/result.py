"""The result line of a run: the metrics the cell's readers find, the
device, the breakdown of a traced run, and the checks."""

from __future__ import annotations

import json
import sys
from typing import Optional

import torch

from benchmark.harness import check, manifest


def _gather(out: dict, chips: int) -> list:
    if chips == 1:
        return [out]
    import torch.distributed as dist

    slim = {k: v for k, v in out.items() if k != "spans"}
    if slim.get("trace"):
        slim["trace"] = {k: v for k, v in slim["trace"].items() if k != "ops"}
    got = [None] * chips
    dist.all_gather_object(got, slim)
    return got


def run_context(out: dict, outs: list, chips: int) -> dict:
    """What the metric readers read (benchmark/metrics/*.py)."""
    run = dict(out)
    run["world"] = chips
    run["peak_bytes"] = max(o["peak_bytes"] for o in outs)
    if out.get("trace"):
        traces = [o["trace"] for o in outs if o.get("trace")]
        run["trace"] = dict(out["trace"])
        run["trace"]["busy_s_mean"] = sum(t["busy_s"] for t in traces) / len(traces)
        run["trace"]["window_s_mean"] = sum(t["window_s"] for t in traces) / len(traces)
    return run


def assemble(cell: dict, out: dict, parts: dict, traced: bool, chips: int,
             rank: int) -> Optional[dict]:
    outs = _gather(out, chips)
    if rank != 0:
        return None
    numbers = {}
    for o in outs:
        for k, v in o["numbers"].items():
            numbers[k] = max(numbers.get(k, v), v)
    limits = cell["limits"]
    run = run_context(out, outs, chips)
    metrics = manifest.read_all(cell["per_layer"] if traced else cell["end_to_end"], run)
    device = {"platform": "gpu",
              "kind": torch.cuda.get_device_name() if torch.cuda.is_available() else "none",
              "count": chips,
              "memory_peak_bytes": int(run["peak_bytes"])}
    line = {"correct": check.judge(numbers, limits),
            "attempted": int(out.get("attempted", out.get("steps", out.get("chunks", 0)))),
            "failed": int(out.get("failed", 0)), "metrics": metrics, "device": device}
    if traced and run.get("trace"):
        device["busy_s"] = run["trace"]["busy_s_mean"]
        device["window_s"] = run["trace"]["window_s_mean"]
        line["breakdown"] = run["trace"]["breakdown"]
    line["checks"] = check.describe(numbers, limits)
    line["_stderr"] = {"setup_parts_s": parts, "window_s": out["window_s"],
                       "not_compared": {k: v for k, v in numbers.items() if k not in limits},
                       "check_s": out.get("check_s"), "losses": out.get("losses"),
                       "ref_losses": out.get("ref_losses")}
    return line


def emit(line: dict) -> None:
    extra = line.pop("_stderr")
    print(json.dumps(extra), file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)

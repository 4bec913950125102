"""One ``torch.profiler`` window and what the per-layer readers take from
it: the device operations (kernels, copies, fills) with their times, the
host operations around them, the busy time as the union of the device
intervals, and the breakdown the result line carries."""

from __future__ import annotations

import json
import os
import re
import time
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def short(name: str, n: int = 64) -> str:
    return re.sub(r"[^A-Za-z0-9_:.]", "_", name)[:n]


class Window:
    """Start with :meth:`start`, end with :meth:`stop` (each syncs the
    card); :meth:`read` parses the trace (a Chrome trace written to
    ``tmpdir`` and deleted)."""

    def __init__(self, tmpdir: str):
        self.tmpdir = tmpdir
        self.prof = None
        self.t0 = self.t1 = None

    def prime(self) -> None:
        """Start and stop the profiler once around one kernel: its first
        start loads and sets up the tracing library, which takes seconds
        and belongs in set-up, not in the window."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        # the device's activity alone (with the CUDA runtime calls that
        # label the idle gaps): recording every host operation would slow
        # the host that paces these steps, and widen the idle share
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t1 is None

    def read(self) -> dict:
        path = os.path.join(self.tmpdir, f"bench_trace_{os.getpid()}.json")
        self.prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        dev: List[Tuple[str, float, float]] = []
        host: List[Tuple[str, float, float]] = []
        for e in events:
            cat = e.get("cat")
            if e.get("ph") != "X":
                continue
            if cat in DEVICE_CATS:
                dev.append((e["name"], float(e["ts"]), float(e.get("dur", 0.0))))
            elif cat in ("cpu_op", "cuda_runtime", "cuda_driver"):
                host.append((e["name"], float(e["ts"]), float(e.get("dur", 0.0))))
        return summarize(dev, host, self.t1 - self.t0)


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarize(dev, host, window_s: float) -> dict:
    """dev, host: (name, start us, duration us). Returns busy seconds, the
    window, device seconds and launches by name, and the breakdown."""
    busy = merge([(ts, ts + d) for _, ts, d in dev])
    busy_s = sum(b - a for a, b in busy) / 1e6
    by_name: Dict[str, List[float]] = {}
    for name, _, d in dev:
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += d / 1e6
        acc[1] += 1
    # each idle gap is labelled by the innermost host call in progress at
    # its middle (the gaps' middles rise, so one sweep over the calls)
    gaps: Dict[str, float] = {}
    calls = sorted(host, key=lambda h: h[1])
    i, active = 0, []
    for (_, a1), (b0, _) in zip(busy, busy[1:]):
        mid = (a1 + b0) / 2
        while i < len(calls) and calls[i][1] <= mid:
            active.append(calls[i])
            i += 1
        active = [c for c in active if c[1] + c[2] >= mid]
        label = short(max(active, key=lambda c: c[1])[0]) if active else "host_between_calls"
        gaps[label] = gaps.get(label, 0.0) + (b0 - a1) / 1e6
    top_ops = sorted(((short(k), v[0]) for k, v in by_name.items()), key=lambda kv: -kv[1])
    merged_ops: Dict[str, float] = {}
    for k, v in top_ops:
        merged_ops[k] = merged_ops.get(k, 0.0) + v
    return {
        "window_s": window_s,
        "busy_s": busy_s,
        "ops": {k: (v[0], v[1]) for k, v in by_name.items()},
        "breakdown": {
            "device_ops": [[k, v] for k, v in sorted(merged_ops.items(),
                                                      key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
        },
    }


def device_seconds(trace: Optional[dict], pattern: str) -> Tuple[float, int]:
    """(seconds, launches) of the device operations whose name matches."""
    if not trace:
        return 0.0, 0
    rx = re.compile(pattern)
    s, n = 0.0, 0
    for name, (sec, count) in trace["ops"].items():
        if rx.search(name):
            s += sec
            n += count
    return s, n

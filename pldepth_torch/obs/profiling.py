"""Profiling hooks (``pldepth_tpu/obs/profiling.py``): a torch.profiler
trace of a region, with the program's spans (obs/spans.py) laid into it.

The reference disabled profiling outright (TensorBoard callback with
profile_batch=0, pldepth/util/tracking_utils.py:39). ``profile_trace``
records the host's ops, and the card's kernels and copies when CUDA is in
use, and writes one Chrome trace (``<host>_<pid>.<ms>.pt.trace.json``) into
``logdir``, readable by chrome://tracing, Perfetto or TensorBoard's
profiler plugin. The spans recorded over the region (``step.forward``,
``mesh.all_reduce``, ...) are events of that trace on its own clock, on
the threads that opened them, above the ops they launched.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from typing import Iterator, List

import torch

from pldepth_torch.obs import spans as spans_lib


def _sync_all() -> None:
    """Wait for every CUDA device this process has used."""
    if torch.cuda.is_initialized():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


def _span_events(spans: List[spans_lib.Span], base_ns: int, pid: int) -> list:
    """Chrome trace events ("X", microseconds from the trace's
    ``baseTimeNanoseconds``) of ``spans``; waits with no thread go on a
    track of their own (tid 0)."""
    return [{"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
             "args": {"name": "program waits"}}] + [
        {"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
         "tid": s.thread if s.thread is not None else 0,
         "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"ident": s.ident, "id": s.id, "parent": s.parent}}
        for s in spans]


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    rec = spans_lib.recording()

    def write(prof) -> None:  # after the recording has ended
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}."
                                    f"{time.time_ns() // 1_000_000}.pt.trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        trace["traceEvents"].extend(_span_events(
            rec.spans, int(trace.get("baseTimeNanoseconds", 0)), os.getpid()))
        with open(path, "w") as f:
            json.dump(trace, f)

    with torch.profiler.profile(activities=activities, on_trace_ready=write) as prof, rec:
        yield prof
        _sync_all()  # the region's kernels end inside the trace

"""Profiling hooks (``pldepth_tpu/obs/profiling.py``): a torch.profiler
trace of a region and a device-synced step timer.

The reference disabled profiling outright (TensorBoard callback with
profile_batch=0, pldepth/util/tracking_utils.py:39). ``profile_trace``
records the host's ops, and the card's kernels and copies when CUDA is in
use, and writes one Chrome trace (``<host>_<pid>.<ms>.pt.trace.json``) into
``logdir``, readable by chrome://tracing, Perfetto or TensorBoard's
profiler plugin. ``step_timer`` measures a block up to the end of every
card's work.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch


def _sync_all() -> None:
    """Wait for every CUDA device this process has used."""
    if torch.cuda.is_initialized():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof
        _sync_all()  # the region's kernels end inside the trace


@contextlib.contextmanager
def step_timer(sink, name: str = "step"):
    """Times a block up to the completion of its device work: every CUDA
    device in use is fenced, so a straggler card's tail is included."""
    t0 = time.perf_counter()
    yield
    _sync_all()
    sink({f"{name}_time_s": time.perf_counter() - t0})

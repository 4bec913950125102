"""The program's spans laid over a device trace (harness/span_trace.py) on
made-up events: launches put down to the innermost span open at their
time (on any thread: a runtime call's tid is CUPTI's, not the spans'),
an all-reduce on autograd's thread nested in the span open elsewhere,
nesting counted up the parents; idle gaps relabelled by span where no runtime call covers them;
host and idle time by span."""

import pytest

from benchmark.harness import span_trace
from pldepth_torch.obs.spans import Span

BASE = 1_700_000_000_000_000_000  # ns; the events' ts are us from here
MAIN, AUTOGRAD = 11, 12


def _span(name, t0, t1, thread, sid, parent=None, ident=3):
    return Span(name, BASE + t0 * 1000, BASE + t1 * 1000, thread, sid, parent, ident)


SPANS = [_span("step", 0, 100, MAIN, 0), _span("step.forward", 10, 40, MAIN, 1, 0),
         _span("step.backward", 40, 80, MAIN, 2, 0), _span("step.update", 81, 95, MAIN, 3, 0),
         # an all-reduce on autograd's device thread: no parent there
         _span("mesh.all_reduce", 50, 60, AUTOGRAD, 4, None, None),
         # a wait recorded after the fact, no thread's activity
         _span("serve.queue", 0, 120, None, 5, None, 0)]


def _launch(corr, ts, tid, dur=1.0):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
            "dur": dur, "tid": tid, "args": {"correlation": corr}}


def _kernel(corr, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts, "dur": dur, "tid": 7,
            "args": {"correlation": corr}}


EVENTS = [_launch(1, 12, MAIN), _kernel(1, 20, 10),           # in the forward
          _launch(2, 45, AUTOGRAD), _kernel(2, 46, 4),        # autograd, no span of its own
          _launch(3, 55, AUTOGRAD, 2.0), _kernel(3, 60, 10),  # inside the all-reduce
          _launch(4, 85, MAIN), _kernel(4, 90, 2),            # in the update
          _launch(5, 105, MAIN), _kernel(5, 110, 1),          # under no span
          {"ph": "i", "cat": "kernel", "name": "marker", "ts": 3}]


@pytest.fixture
def got():
    return span_trace.attribute(EVENTS, BASE, SPANS, window_ns=(BASE, BASE + 120_000))


def test_launches_count_for_their_span_and_every_span_it_nests_in(got):
    us = {k: round(v * 1e6, 6) for k, v in got["device_s"].items()}
    assert us == {"step": 26.0, "step.forward": 10.0, "step.backward": 14.0,
                  "mesh.all_reduce": 10.0, "step.update": 2.0}
    assert round(got["unattributed_s"] * 1e6, 6) == 1.0


def test_idle_gaps_take_the_span_where_no_runtime_call_covers_them(got):
    us = {k: round(v * 1e6, 6) for k, v in got["idle_gaps"].items()}
    # head [0, 20] and [30, 46]: the forward is open; [50, 60] under the
    # launch at 55; [70, 90] in the backward; [92, 110] and the tail
    # [111, 120] under no span
    assert us == {"span:step.forward": 36.0, "cudaLaunchKernel": 10.0,
                  "span:step.backward": 20.0, "host_between_calls": 27.0}


def test_host_and_idle_time_by_span(got):
    host = {k: round(v * 1e6, 6) for k, v in got["host_s"].items()}
    assert host == {"step": 100.0, "step.forward": 30.0, "step.backward": 40.0,
                    "step.update": 14.0, "mesh.all_reduce": 10.0, "serve.queue": 120.0}
    assert got["count"] == {n: 1 for n in host}
    idle = {k: round(v * 1e6, 6) for k, v in got["idle_s"].items()}
    assert idle == {"step": 74.0, "step.forward": 20.0, "step.backward": 26.0,
                    "step.update": 12.0, "mesh.all_reduce": 10.0, "serve.queue": 93.0}


def test_without_the_window_idle_lies_between_operations():
    got = span_trace.attribute(EVENTS, BASE, SPANS)
    assert round(sum(got["idle_gaps"].values()) * 1e6, 6) == 64.0
    assert round(got["idle_s"]["step"] * 1e6, 6) == 54.0
    assert span_trace.attribute(EVENTS, BASE, [])["idle_gaps"] == {
        "cudaLaunchKernel": 10e-6, "host_between_calls": 54e-6}

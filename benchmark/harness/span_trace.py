"""The program's spans (``pldepth_torch/obs/spans.py``) laid over one
``torch.profiler`` window's Chrome trace: which program phase launched
each device operation, which phase the host was in during each idle gap,
and how long the host spent in each.

A span's stamps are on the trace's clock (an event's ``ts`` in
microseconds plus ``baseTimeNanoseconds`` / 1000) and its thread is the
trace's ``tid`` of host operations. A device operation is put down to the
runtime call that launched it (the trace's ``correlation`` id), and that
launch to the innermost span open at its time on any thread: by time, not
by thread, since a runtime call's ``tid`` is CUPTI's thread id (the low
32 bits of ``pthread_self``), not the native one, and since autograd's
device thread, which launches a backward, opens no span of its own but
an all-reduce's. The operation counts for that span and for every span
it nests in: up its parents, and from a span that has none, on to the
span open elsewhere when it began (an all-reduce on autograd's thread
nests in ``step.backward``). Waits recorded after the fact (no thread)
count for host and idle time only.

An idle gap under a CUDA runtime call keeps that call's name, as the
trace's own breakdown labels it; one under none is labelled
``span:<name>`` of the innermost span open at its middle, and
``host_between_calls`` only where no span was open. With
no spans this gives ``trace.summarize``'s labels; the run that reads
these spans takes its gap labels from here instead of from ``summarize``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from benchmark.harness.trace import DEVICE_CATS, merge, short

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op",) + LAUNCH_CATS


class _S:
    """A span in the trace's microseconds."""

    __slots__ = ("name", "t0", "t1", "thread", "id", "parent")

    def __init__(self, s, base_ns: int):
        self.name, self.thread, self.id, self.parent = s.name, s.thread, s.id, s.parent
        self.t0 = (s.start_ns - base_ns) / 1e3
        self.t1 = (s.end_ns - base_ns) / 1e3


def _innermost(points: Sequence[float], spans: List[_S], strict: bool = False) -> list:
    """For each time in ``points`` (ascending), the open span of ``spans``
    that began last (begun before it, if ``strict``), or None."""
    order = sorted(spans, key=lambda s: s.t0)
    out, i, active = [], 0, []
    for t in points:
        while i < len(order) and (order[i].t0 < t if strict else order[i].t0 <= t):
            active.append(order[i])
            i += 1
        active = [s for s in active if s.t1 >= t]
        out.append(max(active, key=lambda s: s.t0) if active else None)
    return out


def _at(times: List[float], spans: List[_S]) -> List[Optional[_S]]:
    """For each time, the innermost span of ``spans`` open then."""
    order = sorted(range(len(times)), key=lambda k: times[k])
    out: List[Optional[_S]] = [None] * len(times)
    for k, s in zip(order, _innermost([times[k] for k in order], spans)):
        out[k] = s
    return out


def _overlap(xs: List[Tuple[float, float]], ys: List[Tuple[float, float]]) -> float:
    """Total length of the intersection of two sorted disjoint lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def attribute(events: list, base_ns: int, spans: Sequence,
              window_ns: Optional[Tuple[int, int]] = None) -> dict:
    """``events``: a Chrome trace's ``traceEvents``; ``base_ns``: its
    ``baseTimeNanoseconds`` (0 where its ``ts`` are absolute); ``spans``:
    the window's ``Span`` records; ``window_ns``: the window's bounds on
    the same clock (idle before the first and after the last operation
    counts too). Seconds by span name: ``device_s`` of the operations each
    launched (nesting included), ``idle_s`` of the idle time while one was
    open, ``host_s`` of the spans themselves, and ``count``;
    ``unattributed_s``, device seconds launched under no span;
    ``idle_gaps``, idle seconds by label."""
    sp = [_S(s, base_ns) for s in spans]
    by_id = {s.id: s for s in sp}
    bound = [s for s in sp if s.thread is not None]
    dev, launch, host = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            dev.append((float(e["ts"]), float(e.get("dur", 0.0)),
                        (e.get("args") or {}).get("correlation")))
        if cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = float(e["ts"])
        if cat in HOST_CATS:
            host.append((e["name"], float(e["ts"]), float(e.get("dur", 0.0))))
    dev.sort(key=lambda op: op[:2])

    # the chain of names an operation launched inside span s counts for
    roots = [s for s in bound if s.parent is None]
    roots.sort(key=lambda s: s.t0)
    adopt = {}
    for r, s in zip(roots, _innermost([r.t0 for r in roots], bound, strict=True)):
        if s is not None and s.thread != r.thread:
            adopt[r.id] = s
    chains: Dict[int, Tuple[str, ...]] = {}

    def chain(s: _S) -> Tuple[str, ...]:
        got = chains.get(s.id)
        if got is None:
            names, seen, cur = [], set(), s
            while cur is not None and cur.id not in seen:
                seen.add(cur.id)
                if cur.name not in names:
                    names.append(cur.name)
                cur = by_id.get(cur.parent) if cur.parent is not None else adopt.get(cur.id)
            got = chains[s.id] = tuple(names)
        return got

    launches = [launch.get(corr) for _, _, corr in dev]
    found = iter(_at([at for at in launches if at is not None], bound))
    owner = [next(found) if at is not None else None for at in launches]
    device_s: Dict[str, float] = {}
    unattributed = 0.0
    for (_, d, _), s in zip(dev, owner):
        if s is None:
            unattributed += d / 1e6
            continue
        for name in chain(s):
            device_s[name] = device_s.get(name, 0.0) + d / 1e6

    busy = merge([(ts, ts + d) for ts, d, _ in dev])
    idle = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    if window_ns is not None and busy:
        w0, w1 = ((w - base_ns) / 1e3 for w in window_ns)
        idle = ([(w0, busy[0][0])] if busy[0][0] > w0 else []) + idle + (
            [(busy[-1][1], w1)] if w1 > busy[-1][1] else [])

    # labels: the host call in progress at the gap's middle, else the span
    calls = sorted(host, key=lambda h: h[1])
    labels: Dict[str, float] = {}
    mids = [(a + b) / 2 for a, b in idle]
    i, active, pending = 0, [], []
    for k, (mid, (a, b)) in enumerate(zip(mids, idle)):
        while i < len(calls) and calls[i][1] <= mid:
            active.append(calls[i])
            i += 1
        active = [c for c in active if c[1] + c[2] >= mid]
        if active:
            name = short(max(active, key=lambda c: c[1])[0])
            labels[name] = labels.get(name, 0.0) + (b - a) / 1e6
        else:
            pending.append(k)
    for k, s in zip(pending, _at([mids[k] for k in pending], bound)):
        a, b = idle[k]
        label = f"span:{s.name}" if s is not None else "host_between_calls"
        labels[label] = labels.get(label, 0.0) + (b - a) / 1e6

    host_s: Dict[str, float] = {}
    count: Dict[str, int] = {}
    intervals: Dict[str, list] = {}
    for s in sp:
        host_s[s.name] = host_s.get(s.name, 0.0) + (s.t1 - s.t0) / 1e6
        count[s.name] = count.get(s.name, 0) + 1
        intervals.setdefault(s.name, []).append((s.t0, s.t1))
    idle_s = {n: _overlap(merge(v), idle) / 1e6 for n, v in intervals.items()}
    return {"device_s": device_s, "idle_s": idle_s, "host_s": host_s, "count": count,
            "unattributed_s": unattributed,
            "idle_gaps": dict(sorted(labels.items(), key=lambda kv: -kv[1]))}

"""Program spans: named intervals of the host's work inside the train step,
the feed, the mesh and the serving loop, kept in memory while whoever owns
a measurement window (a benchmark, ``profile_trace``) has switched the
recorder on.

A span records its name, start and end, its thread, its parent (the
innermost span open on the same thread when it opened) and one shared
identifier: the train step (``state.step``) or the serving chunk's index,
given where the step or chunk begins and inherited from the parent below
it. Stamps are ``time.time_ns()``, the clock of a ``torch.profiler``
Chrome trace (an event's ``ts`` in microseconds plus the trace's
``baseTimeNanoseconds`` / 1000), and the thread is the native id that the
trace's host operations carry as ``tid`` (its runtime calls carry CUPTI's
own thread id), so a span can be laid over the device's trace.

Off by default: a span site tests one flag and gets a shared no-op
context, with no clock read, string or allocation. The owner of a
measurement window switches recording on and off with :class:`recording`,
which hands back the finished spans; nothing is written anywhere while
spans are recorded.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import List, NamedTuple, Optional

__all__ = ["Span", "span", "add", "stamp", "recording"]


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: Optional[int]  # native thread id; None: a wait that no thread spends
    id: int
    parent: Optional[int]  # the parent's ``id``
    ident: Optional[int]  # the train step or the serving chunk


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Recorder:
    def __init__(self):
        self.spans: List[Span] = []
        self._ids = itertools.count()
        self._local = threading.local()

    def thread(self):
        """This thread's open spans (``.stack``) and native id (``.tid``,
        read once: on some hosts it is a system call)."""
        loc = self._local
        if not hasattr(loc, "stack"):
            loc.stack, loc.tid = [], threading.get_native_id()
        return loc


class _Open:
    __slots__ = ("rec", "name", "ident", "t0", "id", "parent", "loc")

    def __init__(self, rec: _Recorder, name: str, ident: Optional[int]):
        self.rec, self.name, self.ident = rec, name, ident

    def __enter__(self):
        self.loc = loc = self.rec.thread()
        stack = loc.stack
        if stack:
            top = stack[-1]
            self.parent = top.id
            if self.ident is None:
                self.ident = top.ident
        else:
            self.parent = None
        self.id = next(self.rec._ids)
        stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.loc.stack.pop()
        self.rec.spans.append(Span(self.name, self.t0, t1, self.loc.tid, self.id, self.parent,
                                   self.ident))
        return False


_active: Optional[_Recorder] = None


def span(name: str, ident: Optional[int] = None):
    """A context that records ``name`` over its body while recording is
    on; ``ident`` defaults to the parent's."""
    rec = _active
    if rec is None:
        return _NOOP
    return _Open(rec, name, ident)


def stamp() -> Optional[int]:
    """The clock while recording is on, else None (for :func:`add`)."""
    return time.time_ns() if _active is not None else None


def add(name: str, start_ns: Optional[int], end_ns: int, ident: Optional[int] = None) -> None:
    """Record a wait measured after the fact (``start_ns`` from
    :func:`stamp`, possibly on another thread): no thread's activity, so
    it has no thread and no parent. Nothing while recording is off or
    when ``start_ns`` is None."""
    rec = _active
    if rec is None or start_ns is None:
        return
    rec.spans.append(Span(name, start_ns, max(start_ns, end_ns), None, next(rec._ids), None,
                          ident))


class recording:
    """``with recording() as got:`` records over the body; ``got.spans``
    holds the spans that ended meanwhile, by start. One window at a time."""

    def __enter__(self):
        global _active
        if _active is not None:
            raise RuntimeError("span recording is already on")
        _active = self.rec = _Recorder()
        self.spans: List[Span] = []
        return self

    def __exit__(self, *exc):
        global _active
        _active = None
        self.spans = sorted(self.rec.spans, key=lambda s: (s.start_ns, s.id))
        return False

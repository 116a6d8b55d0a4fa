"""Host-time spans of the port: what the host was doing, and when, on the
clock of ``torch.profiler``'s trace.

``span(name, **counts)`` marks a stretch of host work (a GA generation's
breeding, an evaluator's upload, a service iteration, a layer's mixture of
experts); ``add(**counts)`` adds counts (bytes gathered, rows computed) to
the innermost open span. Nothing is recorded until ``recording()`` turns
the recorder on; ``summary()`` then returns, per span name, the number of
spans, their host seconds, their summed counts and their raw intervals::

    from repro_torch import spans

    with spans.recording():
        search_mapping(...)
    s = spans.summary()
    s["spans"]["ga.breed"]["host_s"]

Off (the default), ``span`` is one read of a module global and the return
of one shared object that does nothing: no clock, no lock, no list. On, a
span stamps ``time.perf_counter_ns()`` where it opens and where it closes,
and ``summary()`` moves the stamps onto the profiler's clock (Unix-epoch
nanoseconds) through an anchor pair ``(perf_counter_ns, time_ns)`` taken
when recording starts, so that a span can be laid over a device trace
taken at the same time.

Spans record host time by design. No span synchronises the device or
reads a tensor's value: a span around eager torch calls ends when the
host has issued them, not when the device has run them (the lint's RT006
flags timers that measure that way by mistake; here it is the point).
Device time comes from the device trace alone.

The recorder is for one thread: the thread that starts recording is the
one whose spans it keeps (the service's engine loop and a mapping search
each run on one thread); spans opened on other threads are not recorded.
The module uses the standard library only, so any module of the port can
import it.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager

__all__ = ["span", "add", "recording", "start", "stop", "active", "summary"]


class _Noop:
    """The span every call returns while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Recording:
    """One stretch of recording: its anchor, its records and the stack of
    open spans (indices into ``records``)."""

    def __init__(self):
        self.thread = threading.get_ident()
        self.anchor = (time.perf_counter_ns(), time.time_ns())
        self.start_ns = self.anchor[0]
        self.stop_ns: int | None = None
        # [name, t0_ns, t1_ns (0 while open), counts], in the order the
        # spans opened
        self.records: list[list] = []
        self.stack: list[int] = []


class _Span:
    __slots__ = ("rec", "name", "counts", "i")

    def __init__(self, rec: _Recording, name: str, counts: dict):
        self.rec, self.name, self.counts = rec, name, counts

    def __enter__(self):
        rec = self.rec
        self.i = len(rec.records)
        rec.records.append([self.name, time.perf_counter_ns(), 0,
                            self.counts])
        rec.stack.append(self.i)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec.records[self.i][2] = time.perf_counter_ns()
        if rec.stack and rec.stack[-1] == self.i:
            rec.stack.pop()
        return False


_ON: _Recording | None = None       # the recording in progress
_LAST: _Recording | None = None     # the latest one, read by summary()


def span(name: str, **counts):
    """A context manager that records the host time between its entry and
    its exit under ``name``, with ``counts`` (numbers, summed per name)."""
    rec = _ON
    if rec is None:
        return _NOOP
    if rec.thread != threading.get_ident():
        return _NOOP
    return _Span(rec, name, counts)


def add(**counts) -> None:
    """Add ``counts`` to the innermost open span (dropped if none is
    open, or the recorder is off)."""
    rec = _ON
    if rec is None or not rec.stack or rec.thread != threading.get_ident():
        return
    c = rec.records[rec.stack[-1]][3]
    for k, v in counts.items():
        c[k] = c.get(k, 0) + v


def active() -> bool:
    """Whether the recorder is on."""
    return _ON is not None


def start() -> None:
    """Turn the recorder on, from a fresh record (the previous one is
    dropped); the calling thread is the one recorded."""
    global _ON, _LAST
    _ON = _LAST = _Recording()


def stop() -> None:
    """Turn the recorder off; ``summary()`` reads what it recorded, every
    span cut at this moment."""
    global _ON
    if _ON is not None:
        _ON.stop_ns = time.perf_counter_ns()
        _ON = None


@contextmanager
def recording():
    """The recorder on for the body of a ``with`` block."""
    start()
    try:
        yield
    finally:
        stop()


def summary() -> dict:
    """What the latest recording holds, on the profiler's clock (Unix-epoch
    nanoseconds): ``start_ns`` and ``stop_ns`` of the recording, and per
    span name its ``count``, ``host_s``, summed ``counts`` and raw
    ``intervals`` ([t0_ns, t1_ns] in the order the spans opened). Spans
    are cut at ``stop_ns`` (now, while recording): one still open then, or
    closed after, ends there. Empty if nothing was ever recorded."""
    rec = _LAST
    if rec is None:
        return {}
    off = rec.anchor[1] - rec.anchor[0]
    end = rec.stop_ns if rec.stop_ns is not None else time.perf_counter_ns()
    out: dict[str, dict] = {}
    for name, t0, t1, counts in list(rec.records):
        t1 = min(t1, end) if t1 else end
        s = out.get(name)
        if s is None:
            s = out[name] = {"count": 0, "host_s": 0.0, "counts": {},
                             "intervals": []}
        s["count"] += 1
        s["host_s"] += (t1 - t0) / 1e9
        for k, v in counts.items():
            s["counts"][k] = s["counts"].get(k, 0) + v
        s["intervals"].append([t0 + off, t1 + off])
    return {"clock": "unix_ns", "start_ns": rec.start_ns + off,
            "stop_ns": end + off, "spans": out}

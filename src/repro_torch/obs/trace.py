"""Span tracing for the streaming/partitioning stack.

A ``Tracer`` records nested wall-clock spans from any thread — the
engine's prefetch thread and main thread each get their own lane — as
Chrome ``trace_event`` complete events (``ph: "X"``), so one run exports
straight into Perfetto / ``chrome://tracing`` (see ``repro_torch.obs.export``).

Two recording styles, both thread-safe:

* ``with tracer.span("dispatch", cat="engine", chunk=i): ...`` — a
  context-managed span (begin on enter, complete event on exit).  Spans
  opened and closed on the same thread nest correctly by construction.
* ``tracer.complete("read", "prefetch", dt_seconds, chunk=i)`` — emit a
  span retrospectively from an already-measured duration ending *now*.
  This is what hot loops use: one timer read + one list append, no
  context-manager overhead, and no spurious span when a generator is
  abandoned mid-``next``.

Disabled tracing is the ``NULL_TRACER`` singleton whose ``span`` returns
one reusable no-op context manager and whose ``complete`` is a no-op —
instrumentation points cost a couple of attribute lookups when tracing is
off, and a traced run is bit-identical to an untraced one (tracing only
*observes* the pipeline, never reorders it).

Instrumentation points that cannot thread a tracer argument through
(e.g. halo planning called from inside ``PartitionArtifact.save``) use
the process-global active tracer::

    with use_tracer(tracer):
        ...                    # get_tracer() returns `tracer` here,
                               # including from worker threads

The active-tracer stack is deliberately process-global, not
thread-local: the engine's prefetch thread must record into the same
trace as the main thread that activated it.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "get_tracer",
           "use_tracer"]


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """No-op tracer: every instrumentation point degrades to a constant
    attribute lookup.  ``enabled`` is the one flag consumers branch on
    (e.g. the engine only attaches a stall report when it is True)."""

    enabled = False
    __slots__ = ()

    def span(self, name, cat="", **args):
        return _NULL_SPAN

    def complete(self, name, cat="", duration_s=0.0, **args):
        pass

    def instant(self, name, cat="", **args):
        pass

    def counter(self, name, value, series="value"):
        pass

    def events(self):
        return []

    @property
    def dropped(self):
        return 0


NULL_TRACER = NullTracer()


class _Span:
    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer, name, cat, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._t0 = self._tracer._now_us()
        return self

    def __exit__(self, *exc):
        t1 = self._tracer._now_us()
        self._tracer._emit("X", self._name, self._cat, self._t0,
                           dur=t1 - self._t0, args=self._args)
        return False


class Tracer:
    """In-memory span recorder (Chrome ``trace_event`` shaped dicts).

    ``max_events`` bounds memory on graph-sized runs: past the cap new
    events are counted in ``dropped`` instead of stored (the stall report
    and metrics registry keep their own accumulators, so attribution
    survives a capped trace).
    """

    enabled = True

    def __init__(self, max_events: int = 500_000):
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._dropped = 0
        self._max_events = max_events
        self._pid = os.getpid()
        self._named_tids: set[int] = set()
        self._t0 = time.perf_counter()

    # -- clock -----------------------------------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    # -- recording -------------------------------------------------------
    def _emit(self, ph, name, cat, ts, *, dur=None, args=None):
        tid = threading.get_ident()
        with self._lock:
            if tid not in self._named_tids:
                self._named_tids.add(tid)
                self._events.append({
                    "ph": "M", "name": "thread_name", "pid": self._pid,
                    "tid": tid,
                    "args": {"name": threading.current_thread().name}})
            if len(self._events) >= self._max_events:
                self._dropped += 1
                return
            ev = {"ph": ph, "name": name, "cat": cat or "repro",
                  "pid": self._pid, "tid": tid, "ts": ts}
            if dur is not None:
                ev["dur"] = max(dur, 0.0)
            if ph == "i":
                ev["s"] = "t"
            if args:
                ev["args"] = args
            self._events.append(ev)

    def span(self, name: str, cat: str = "", **args):
        """Context manager recording one complete span."""
        return _Span(self, name, cat, args)

    def complete(self, name: str, cat: str = "", duration_s: float = 0.0,
                 **args):
        """Record a span of ``duration_s`` seconds that ends *now*.  The
        start is clamped to the tracer's epoch so a duration measured
        before the tracer existed still yields a valid (ts >= 0) event."""
        now = self._now_us()
        self._emit("X", name, cat, max(now - duration_s * 1e6, 0.0),
                   dur=duration_s * 1e6, args=args)

    def instant(self, name: str, cat: str = "", **args):
        self._emit("i", name, cat, self._now_us(), args=args)

    def counter(self, name: str, value, series: str = "value"):
        """Record a counter sample (rendered as a track in Perfetto)."""
        self._emit("C", name, "metrics", self._now_us(),
                   args={series: float(value)})

    # -- export ----------------------------------------------------------
    def events(self) -> list[dict]:
        """Snapshot of recorded events (copy — safe to serialize while
        other threads keep tracing)."""
        with self._lock:
            return list(self._events)

    @property
    def dropped(self) -> int:
        return self._dropped


# ---------------------------------------------------------------------------
# process-global active tracer
# ---------------------------------------------------------------------------

_ACTIVE: list = [NULL_TRACER]


def get_tracer():
    """The innermost tracer activated via ``use_tracer`` (NULL_TRACER when
    none is active).  Worker threads see the same tracer as the thread
    that activated it."""
    return _ACTIVE[-1]


@contextlib.contextmanager
def use_tracer(tracer):
    """Make ``tracer`` the process-global active tracer for the block.
    ``None`` is accepted and treated as NULL_TRACER (so callers can pass
    an optional through unconditionally)."""
    _ACTIVE.append(NULL_TRACER if tracer is None else tracer)
    try:
        yield _ACTIVE[-1]
    finally:
        _ACTIVE.pop()

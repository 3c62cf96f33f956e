"""Metrics registry: counters, gauges, histograms with snapshot export.

The partitioning/halo stack records its operational numbers here —
edges/sec, chunks in flight, replication-state bytes, DCN vs ICI lane
rows — so launchers and benchmarks can export one JSON-safe snapshot
instead of scraping prints.  Canonical instrument names:

    engine.edges_streamed        counter  edges entering the pipeline
    engine.chunks_total          counter  chunks dispatched (all passes)
    engine.chunks_in_flight      gauge    deque occupancy (high-water in
                                          ``max``)
    engine.edges_per_sec         gauge    streamed edges / pass wall time
    engine.replication_state_bytes
                                 gauge    final replication bit-matrix size
    engine.dispatch_seconds      histogram  per-chunk host dispatch time
    engine.writeback_seconds     histogram  per-chunk writeback time
    engine.io_retries            counter  chunk reads recovered by the
                                          retrying stream (repro.robust)
    engine.checkpoints           counter  engine checkpoints written
    engine.resumes               counter  runs restarted from a checkpoint
    engine.shards                gauge    workers in a sharded run
                                          (repro_torch.shard; 0/absent when
                                          sequential)
    shard.merge_seconds          histogram  per-round shard state merge
                                          time (repro_torch.shard)
    halo.boundary_rows           gauge    flat pairwise exchange rows
    halo.dcn_rows_aggregated     gauge    host-grouped DCN lane rows
    halo.dcn_rows_naive          gauge    rows a flat layout would ship
                                          cross-host
    halo.intra_rows              gauge    rows staying on ICI (intra-host)
    sample.minibatches           counter  ego-network samples drawn
    sample.edges_local           counter  sampled edges read from the
                                          serving (home) partition
    sample.edges_halo            counter  sampled edges read across a
                                          halo replica boundary
    sample.cache.hits            counter  feature rows served from the
                                          hot-vertex cache
    sample.cache.misses          counter  rows that paid the remote fetch
    sample.cache.evictions       counter  LRU-overlay evictions
    sample.local_graphs_built    gauge    partitions lowered to local CSC
    serve.p50_ms / serve.p99_ms  gauge    request latency percentiles
                                          (compile warm-up excluded)
    serve.fetch_failures         counter  feature rows served degraded
                                          after fetch retry exhaustion

Instruments are get-or-create by name (``registry.counter("x")``), all
updates are thread-safe, and ``registry.snapshot()`` returns plain dicts.
``NULL_REGISTRY`` is the disabled no-op twin (same null-object pattern as
``repro_torch.obs.trace.NULL_TRACER``); ``use_registry`` / ``get_registry``
mirror the active-tracer stack for call sites that cannot thread a
registry argument through.
"""
from __future__ import annotations

import contextlib
import math
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "NullRegistry", "NULL_REGISTRY", "get_registry", "use_registry"]


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock):
        self._lock = lock
        self.value = 0

    def inc(self, n=1):
        with self._lock:
            self.value += n

    def snapshot(self):
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-set value, with the high-water mark kept in ``max``."""

    __slots__ = ("_lock", "value", "max")

    def __init__(self, lock):
        self._lock = lock
        self.value = 0.0
        self.max = -math.inf

    def set(self, v):
        with self._lock:
            self.value = v
            if v > self.max:
                self.max = v

    def snapshot(self):
        return {"type": "gauge", "value": self.value,
                "max": self.max if self.max != -math.inf else self.value}


class Histogram:
    """Streaming histogram: count/sum/min/max plus power-of-two buckets
    (bucket ``i`` counts observations in ``(2^(i-1), 2^i] * base``, with
    ``base`` = 1e-6 so sub-microsecond to kilosecond durations all land
    in a small fixed range)."""

    __slots__ = ("_lock", "count", "total", "min", "max", "buckets")
    _BASE = 1e-6

    def __init__(self, lock):
        self._lock = lock
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: dict[int, int] = {}

    def observe(self, v):
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            b = 0 if v <= self._BASE else math.ceil(math.log2(v / self._BASE))
            self.buckets[b] = self.buckets.get(b, 0) + 1

    def snapshot(self):
        if not self.count:
            return {"type": "histogram", "count": 0}
        return {"type": "histogram", "count": self.count,
                "sum": self.total, "mean": self.total / self.count,
                "min": self.min, "max": self.max,
                "buckets": {f"le_{(2 ** b) * self._BASE:.0e}": n
                            for b, n in sorted(self.buckets.items())}}


class MetricsRegistry:
    """Name -> instrument map; instruments are created on first use so
    call sites never need to pre-declare what they record."""

    enabled = True

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, object] = {}

    def _get(self, name, cls):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(self._lock)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict:
        """JSON-safe ``{name: {type, ...}}`` snapshot of every
        instrument."""
        with self._lock:
            items = list(self._instruments.items())
        return {name: inst.snapshot() for name, inst in items}


class _NullInstrument:
    __slots__ = ()

    def inc(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass


_NULL_INSTRUMENT = _NullInstrument()


class NullRegistry:
    """Disabled registry: every instrument is one shared no-op."""

    enabled = False
    __slots__ = ()

    def counter(self, name):
        return _NULL_INSTRUMENT

    def gauge(self, name):
        return _NULL_INSTRUMENT

    def histogram(self, name):
        return _NULL_INSTRUMENT

    def snapshot(self):
        return {}


NULL_REGISTRY = NullRegistry()

_ACTIVE: list = [NULL_REGISTRY]


def get_registry():
    """The innermost registry activated via ``use_registry``
    (NULL_REGISTRY when none is active)."""
    return _ACTIVE[-1]


@contextlib.contextmanager
def use_registry(registry):
    """Make ``registry`` the process-global active registry for the
    block (``None`` -> NULL_REGISTRY)."""
    _ACTIVE.append(NULL_REGISTRY if registry is None else registry)
    try:
        yield _ACTIVE[-1]
    finally:
        _ACTIVE.pop()

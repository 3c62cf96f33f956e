"""Fault injection and bounded-retry IO for the streaming engine.

At the edge counts the ROADMAP targets, a multi-hour partitioning run
*will* see transient storage faults — NFS timeouts, short reads, bit rot
on a cold tier.  This module gives the engine (and tests) both sides of
that story:

* ``FaultyStream`` — deterministic, chunk-indexed fault injection over
  any ``EdgeStream``.  Three fault kinds mirror what real storage does:
  ``ioerror`` (the read raises), ``partial`` (a short read — the chunk
  comes back truncated), ``corrupt`` (vertex ids flipped out of range).
  Faults are keyed by chunk index and fire on the first ``count`` read
  *attempts* of that chunk, then heal — so a retrying consumer recovers
  deterministically, and tests stay bit-reproducible.
* ``RetryPolicy`` + ``ResilientStream`` — a validating, retrying
  ``EdgeStream`` wrapper.  Every chunk is checked against the stream
  geometry (exact expected length per index, vertex ids in
  ``[0, num_vertices)``), so ``partial``/``corrupt`` faults are *detected*
  rather than silently partitioned; any read failure re-opens the
  underlying stream at the failed chunk and retries with bounded
  backoff.  Retries land in the ``engine.io_retries`` counter and as
  ``io_retry`` trace events (``repro_torch.obs``).
* ``ResilientFetcher`` — the serving-side analogue: timeout + bounded
  retry around a feature ``fetch_fn``, degrading to fallback rows (and a
  ``serve.fetch_failures`` count) when the store stays down, so one dead
  feature shard degrades answers instead of killing the serve loop.

A retried run is **bit-identical** to a fault-free run: validation admits
exactly the chunks the clean stream would produce, in order, and the
engine's pipeline never observes a failed attempt.

A copy of the reference package's ``robust/faults.py`` over the port's
``core.stream`` and ``obs``.
"""
from __future__ import annotations

import concurrent.futures
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator

import numpy as np

from ..core.stream import EdgeStream
from ..obs import get_registry, get_tracer

__all__ = ["ChunkFault", "ChunkReadError", "FaultyStream",
           "ResilientFetcher", "ResilientStream", "RetryPolicy"]

FAULT_KINDS = ("ioerror", "partial", "corrupt")


class ChunkReadError(IOError):
    """A chunk failed validation (short read / out-of-range vertex ids) or
    the stream ended before the expected chunk count."""


@dataclass(frozen=True)
class ChunkFault:
    """Fail the first ``count`` read attempts of chunk ``chunk_index``.

    ``count`` larger than any retry budget makes the fault permanent —
    how tests simulate a dead disk (and how crash tests interrupt a run
    at an exact chunk boundary).
    """

    chunk_index: int
    kind: str = "ioerror"          # 'ioerror' | 'partial' | 'corrupt'
    count: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"fault kind must be one of {FAULT_KINDS} "
                             f"(got {self.kind!r})")
        if self.chunk_index < 0 or self.count < 1:
            raise ValueError("chunk_index must be >= 0 and count >= 1")


class FaultyStream(EdgeStream):
    """Inject deterministic chunk-indexed faults into ``inner``.

    Attempt counts are kept per chunk index across re-reads *and* across
    passes, so "fail the first N attempts" composes correctly with both
    the engine's multi-pass structure and a retrying consumer.
    """

    def __init__(self, inner: EdgeStream, faults: Iterable[ChunkFault]):
        self.inner = inner
        self.num_edges = inner.num_edges
        self.num_vertices = inner.num_vertices
        self.faults: dict[int, ChunkFault] = {}
        for f in faults:
            if f.chunk_index in self.faults:
                raise ValueError(f"duplicate fault for chunk "
                                 f"{f.chunk_index}")
            self.faults[f.chunk_index] = f
        self.attempts: dict[int, int] = {}
        self.fired = 0

    @property
    def simulated_io_seconds(self) -> float:
        return self.inner.simulated_io_seconds

    def _produce(self, i: int, chunk: np.ndarray) -> np.ndarray:
        attempt = self.attempts.get(i, 0)
        self.attempts[i] = attempt + 1
        fault = self.faults.get(i)
        if fault is None or attempt >= fault.count:
            return chunk
        self.fired += 1
        if fault.kind == "ioerror":
            raise IOError(f"injected IO error reading chunk {i} "
                          f"(attempt {attempt})")
        if fault.kind == "partial":
            return chunk[: len(chunk) // 2]
        bad = np.array(chunk, copy=True)
        bad[:: 2] = self.num_vertices + 1 + i      # corrupt: ids out of range
        return bad

    def iter_chunks(self, chunk_size: int) -> Iterator[np.ndarray]:
        for i, chunk in enumerate(self.inner.iter_chunks(chunk_size)):
            yield self._produce(i, chunk)

    def iter_chunks_from(self, chunk_size: int,
                         start_chunk: int = 0) -> Iterator[np.ndarray]:
        it = self.inner.iter_chunks_from(chunk_size, start_chunk)
        for i, chunk in enumerate(it, start=start_chunk):
            yield self._produce(i, chunk)


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry-with-backoff for one chunk read (or one fetch).

    Backoff is deterministic (no jitter): attempt ``a`` sleeps
    ``min(backoff_base_s * backoff_factor**a, max_backoff_s)`` — tests
    stay reproducible and the total stall per chunk is bounded by
    ``max_retries * max_backoff_s``.
    """

    max_retries: int = 3
    backoff_base_s: float = 0.002
    backoff_factor: float = 2.0
    max_backoff_s: float = 0.05

    def __post_init__(self):
        if self.max_retries < 0 or self.backoff_base_s < 0:
            raise ValueError("max_retries and backoff_base_s must be >= 0")

    def backoff_s(self, attempt: int) -> float:
        return min(self.backoff_base_s * self.backoff_factor ** attempt,
                   self.max_backoff_s)


class ResilientStream(EdgeStream):
    """Validate every chunk and retry failed reads with bounded backoff.

    Wraps any ``EdgeStream``; ``run_spec(..., retry_policy=...)`` applies
    it so the degree pass, clustering, and every partitioning pass share
    one retry story.  ``retries`` counts recovery attempts across the
    stream's lifetime (mirrored into the ``engine.io_retries`` counter of
    the active ``repro_torch.obs`` registry at retry time).
    """

    def __init__(self, inner: EdgeStream,
                 policy: RetryPolicy | None = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.inner = inner
        self.policy = policy or RetryPolicy()
        self.num_edges = inner.num_edges
        self.num_vertices = inner.num_vertices
        self.retries = 0
        self._sleep = sleep

    @property
    def simulated_io_seconds(self) -> float:
        return self.inner.simulated_io_seconds

    def _validate(self, chunk: np.ndarray, i: int, chunk_size: int) -> None:
        lo = i * chunk_size
        expect = min(chunk_size, self.num_edges - lo)
        if chunk.shape[0] != expect:
            raise ChunkReadError(
                f"chunk {i}: short read ({chunk.shape[0]} rows, expected "
                f"{expect})")
        if chunk.size and (int(chunk.min()) < 0
                           or int(chunk.max()) >= self.num_vertices):
            raise ChunkReadError(
                f"chunk {i}: vertex id out of range [0, "
                f"{self.num_vertices}) — corrupt read")

    def iter_chunks(self, chunk_size: int) -> Iterator[np.ndarray]:
        yield from self.iter_chunks_from(chunk_size, 0)

    def iter_chunks_from(self, chunk_size: int,
                         start_chunk: int = 0) -> Iterator[np.ndarray]:
        n_chunks = -(-self.num_edges // chunk_size)
        i = start_chunk
        it: Iterator | None = None
        failures = 0                    # consecutive failures on chunk i
        while i < n_chunks:
            try:
                if it is None:
                    it = self.inner.iter_chunks_from(chunk_size, i)
                chunk = next(it, None)
                if chunk is None:
                    raise ChunkReadError(
                        f"stream ended early at chunk {i}/{n_chunks}")
                self._validate(chunk, i, chunk_size)
            except Exception as exc:    # noqa: BLE001 — bounded re-raise
                if hasattr(it, "close"):
                    it.close()
                it = None               # re-open at the failed chunk
                if failures >= self.policy.max_retries:
                    raise ChunkReadError(
                        f"chunk {i}: giving up after "
                        f"{self.policy.max_retries} retries: "
                        f"{exc}") from exc
                self.retries += 1
                get_registry().counter("engine.io_retries").inc()
                get_tracer().complete("io_retry", "robust", 0.0, chunk=i,
                                      error=type(exc).__name__)
                self._sleep(self.policy.backoff_s(failures))
                failures += 1
                continue
            failures = 0
            yield chunk
            i += 1
        if hasattr(it, "close"):
            it.close()


class ResilientFetcher:
    """Timeout + bounded-retry wrapper around a feature ``fetch_fn``.

    A serving loop's remote feature reads (the miss path behind a feature
    cache) are its one RPC-shaped dependency — a dead or slow feature
    shard must not kill the server.  Each call runs ``fetch_fn`` on a
    worker thread with a deadline; failures and timeouts retry per ``policy``, and on
    exhaustion the batch is served **degraded**: ``fallback_row`` (zeros
    by default) for the unfetchable vertices, with the rows counted in
    ``failures`` and the ``serve.fetch_failures`` metric.  While fetches
    succeed, returned rows are bit-identical to calling ``fetch_fn``
    directly.
    """

    def __init__(self, fetch_fn, feat_dim: int, *,
                 timeout_s: float = 1.0,
                 policy: RetryPolicy | None = None,
                 dtype=np.float32,
                 fallback_row: np.ndarray | None = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.fetch_fn = fetch_fn
        self.feat_dim = int(feat_dim)
        self.timeout_s = float(timeout_s)
        self.policy = policy or RetryPolicy()
        self.dtype = np.dtype(dtype)
        self.fallback_row = (np.zeros((self.feat_dim,), self.dtype)
                             if fallback_row is None
                             else np.asarray(fallback_row, self.dtype))
        self.failures = 0               # degraded rows served
        self.retries = 0
        self._sleep = sleep
        # a hung fetch cannot be cancelled, only abandoned — a few spare
        # workers keep later requests from queueing behind a stuck one
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="feature-fetch")

    def __call__(self, gids: np.ndarray) -> np.ndarray:
        gids = np.asarray(gids, np.int64).reshape(-1)
        for attempt in range(self.policy.max_retries + 1):
            fut = self._pool.submit(self.fetch_fn, gids)
            try:
                rows = np.asarray(fut.result(timeout=self.timeout_s),
                                  self.dtype)
                if rows.shape != (len(gids), self.feat_dim):
                    raise ChunkReadError(
                        f"fetch returned shape {rows.shape}, expected "
                        f"{(len(gids), self.feat_dim)}")
                return rows
            except Exception:           # noqa: BLE001 — degrade at the end
                fut.cancel()
                if attempt < self.policy.max_retries:
                    self.retries += 1
                    self._sleep(self.policy.backoff_s(attempt))
        self.failures += len(gids)
        get_registry().counter("serve.fetch_failures").inc(len(gids))
        get_tracer().complete("fetch_degraded", "robust", 0.0,
                              rows=len(gids))
        return np.broadcast_to(self.fallback_row,
                               (len(gids), self.feat_dim)).copy()

    def stats(self) -> dict:
        return {"failures": self.failures, "retries": self.retries,
                "timeout_s": self.timeout_s,
                "max_retries": self.policy.max_retries}

"""Stall attribution for the engine's three-stage pipeline.

The engine overlaps read (prefetch thread), device dispatch, and
writeback; ROADMAP decisions like "grow ``pipeline_depth`` until
writeback stops stalling" need to know which stage the stream actually
waits on.  A ``StallClock`` accumulates, per pass over the edge stream:

* per-stage **busy** time — ``prefetch`` (producer-side chunk read /
  decode, measured on whatever thread runs it), ``dispatch`` (pad +
  ``chunk_fn`` host time), ``writeback`` (device wait + host
  materialization + memmap writes + host folds);
* finer **attribution** buckets — ``queue_wait`` (consumer blocked on
  the prefetch queue), ``device_wait`` (``block_until_ready`` inside
  writeback and the end-of-pass drain), ``host_write`` (writeback minus
  device wait).

``StallClock.report`` rolls one pass into a ``PassStall``; the run-level
``PipelineStallReport`` aggregates passes and renders the verdict.  For
every stage ``busy_frac + idle_frac == 1.0`` exactly (fractions are of
the pass wall time, busy clamped to wall), and the **critical stage** is
the stage with the largest aggregate busy time — the one a deeper
pipeline cannot hide.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

__all__ = ["StallClock", "PassStall", "PipelineStallReport", "STAGES"]

#: The engine's pipeline stages, in stream order.
STAGES = ("prefetch", "dispatch", "writeback")


class StallClock:
    """Thread-safe per-pass accumulator (one instance per StreamPass)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.busy = {s: 0.0 for s in STAGES}
        self.chunks = {s: 0 for s in STAGES}
        self.attribution: dict[str, float] = {}
        self._t0 = time.perf_counter()

    def add(self, stage: str, seconds: float):
        """Credit ``seconds`` of busy time (one chunk) to ``stage``."""
        with self._lock:
            self.busy[stage] = self.busy.get(stage, 0.0) + seconds
            self.chunks[stage] = self.chunks.get(stage, 0) + 1

    def attribute(self, bucket: str, seconds: float):
        """Credit ``seconds`` to a fine-grained attribution bucket."""
        with self._lock:
            self.attribution[bucket] = (
                self.attribution.get(bucket, 0.0) + seconds)

    def report(self, phase: str) -> "PassStall":
        """Close the pass: wall time is now - construction time."""
        wall = time.perf_counter() - self._t0
        with self._lock:
            return PassStall(phase=phase, wall_seconds=wall,
                             busy=dict(self.busy), chunks=dict(self.chunks),
                             attribution=dict(self.attribution))


def _stage_fractions(busy: dict, chunks: dict, wall: float) -> dict:
    stages = {}
    for s in STAGES:
        b = min(busy.get(s, 0.0), wall) if wall > 0 else 0.0
        frac = (b / wall) if wall > 0 else 0.0
        stages[s] = {"busy_s": busy.get(s, 0.0),
                     "idle_s": max(wall - b, 0.0),
                     "busy_frac": frac, "idle_frac": 1.0 - frac,
                     "chunks": chunks.get(s, 0)}
    return stages


def _critical(stages: dict) -> str:
    return max(stages, key=lambda s: stages[s]["busy_s"])


@dataclass
class PassStall:
    """Stall accounting for one sweep over the edge stream."""

    phase: str
    wall_seconds: float
    busy: dict = field(default_factory=dict)      # stage -> seconds
    chunks: dict = field(default_factory=dict)    # stage -> chunk count
    attribution: dict = field(default_factory=dict)

    def stages(self) -> dict:
        return _stage_fractions(self.busy, self.chunks, self.wall_seconds)

    def to_dict(self) -> dict:
        stages = self.stages()
        return {"phase": self.phase,
                "wall_s": self.wall_seconds,
                "stages": stages,
                "attribution": dict(self.attribution),
                "critical_stage": _critical(stages)}


@dataclass
class PipelineStallReport:
    """All passes of one run, plus the aggregate verdict.

    ``to_dict()`` is the JSON-safe shape attached to
    ``PartitionRunResult.extras["stall_report"]`` and artifact manifests
    (see docs/observability.md for the field table); ``from_dict``
    round-trips it.  Per stage, ``busy_frac + idle_frac == 1.0``.
    """

    passes: list = field(default_factory=list)    # [PassStall]

    @property
    def wall_seconds(self) -> float:
        return sum(p.wall_seconds for p in self.passes)

    def stages(self) -> dict:
        busy: dict[str, float] = {}
        chunks: dict[str, int] = {}
        for p in self.passes:
            for s, v in p.busy.items():
                busy[s] = busy.get(s, 0.0) + v
            for s, n in p.chunks.items():
                chunks[s] = chunks.get(s, 0) + n
        return _stage_fractions(busy, chunks, self.wall_seconds)

    @property
    def critical_stage(self) -> str:
        return _critical(self.stages())

    @property
    def verdict(self) -> str:
        """Human verdict: which stage bounds the pipeline, and how hard
        (e.g. ``'dispatch-bound (78% busy)'``)."""
        stages = self.stages()
        crit = _critical(stages)
        return f"{crit}-bound ({stages[crit]['busy_frac']:.0%} busy)"

    def to_dict(self) -> dict:
        return {"wall_s": self.wall_seconds,
                "stages": self.stages(),
                "critical_stage": self.critical_stage,
                "verdict": self.verdict,
                "passes": [p.to_dict() for p in self.passes]}

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineStallReport":
        passes = [PassStall(phase=p["phase"], wall_seconds=p["wall_s"],
                            busy={s: v["busy_s"]
                                  for s, v in p["stages"].items()},
                            chunks={s: v["chunks"]
                                    for s, v in p["stages"].items()},
                            attribution=dict(p.get("attribution", {})))
                  for p in d.get("passes", [])]
        return cls(passes=passes)

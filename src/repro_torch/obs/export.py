"""Exporters: Chrome ``trace_event`` JSON, the human stall table (copies of
the reference package's ``obs/export.py``) and the ``torch.profiler``
session hook, the port's counterpart of the reference's device-profiler
hook.

The Chrome format is the minimal subset Perfetto / ``chrome://tracing``
load: a ``{"traceEvents": [...]}`` document whose events carry
``ph``/``name``/``pid``/``tid``(/``ts``/``dur``) — exactly what
``repro_torch.obs.trace.Tracer`` records.  ``validate_chrome_trace`` checks
that subset (it is the schema the trace-smoke CI stage and the tests
enforce) and returns the distinct complete-span names it saw.
"""
from __future__ import annotations

import contextlib
import json
import os

__all__ = ["chrome_trace", "write_chrome_trace", "validate_chrome_trace",
           "trace_summary_table", "torch_profiler_session",
           "TraceValidationError", "TORCH_TRACE_FILE"]

#: File ``torch_profiler_session`` writes its Chrome trace to, in its dir.
TORCH_TRACE_FILE = "torch_trace.json"

#: Event phases the tracer emits (complete, counter, instant, metadata).
_KNOWN_PHASES = frozenset("XCiM")


class TraceValidationError(ValueError):
    """A document failed the minimal trace_event schema check."""


def chrome_trace(tracer, metadata: dict | None = None) -> dict:
    """Tracer -> loadable Chrome trace document.  ``metadata`` lands in
    ``otherData`` (Perfetto shows it in the trace info panel)."""
    other = dict(metadata or {})
    if tracer.dropped:
        other["dropped_events"] = tracer.dropped
    return {"traceEvents": tracer.events(),
            "displayTimeUnit": "ms",
            "otherData": other}


def write_chrome_trace(path: str, tracer, metadata: dict | None = None):
    """Serialize ``chrome_trace`` to ``path`` (open in ui.perfetto.dev)."""
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer, metadata), f)
        f.write("\n")


def validate_chrome_trace(doc: dict) -> set:
    """Minimal trace_event schema check -> the set of complete-span
    names.  Raises ``TraceValidationError`` on any malformed event, so a
    passing trace is guaranteed to load in Perfetto."""
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise TraceValidationError(
            "not a trace document: need a dict with a 'traceEvents' list")
    if not doc["traceEvents"]:
        raise TraceValidationError("empty traceEvents")
    names = set()
    for i, ev in enumerate(doc["traceEvents"]):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            raise TraceValidationError(f"{where}: not an object")
        ph = ev.get("ph")
        if ph not in _KNOWN_PHASES:
            raise TraceValidationError(f"{where}: bad phase {ph!r}")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise TraceValidationError(f"{where}: missing name")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                raise TraceValidationError(f"{where}: missing int {key!r}")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                raise TraceValidationError(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise TraceValidationError(f"{where}: bad dur {dur!r}")
            names.add(ev["name"])
    return names


def trace_summary_table(report, metrics_snapshot: dict | None = None) -> str:
    """The ``--trace-summary`` table: per-stage busy/idle fractions plus
    the critical-stage verdict (and headline metrics when a registry
    snapshot is supplied).  ``report`` is a ``PipelineStallReport`` or
    its ``to_dict()`` form."""
    rep = report.to_dict() if hasattr(report, "to_dict") else report
    lines = [f"{'stage':<10s} {'busy_s':>9s} {'idle_s':>9s} "
             f"{'busy%':>6s} {'idle%':>6s} {'chunks':>7s}"]
    for stage, st in rep["stages"].items():
        lines.append(f"{stage:<10s} {st['busy_s']:>9.4f} "
                     f"{st['idle_s']:>9.4f} {st['busy_frac']:>6.1%} "
                     f"{st['idle_frac']:>6.1%} {st['chunks']:>7d}")
    lines.append(f"wall {rep['wall_s']:.4f}s over "
                 f"{len(rep.get('passes', []))} pass(es); "
                 f"verdict: {rep['verdict']}")
    for p in rep.get("passes", []):
        attr = ", ".join(f"{k}={v:.4f}s"
                         for k, v in sorted(p["attribution"].items()))
        lines.append(f"  pass {p['phase']:<14s} wall {p['wall_s']:.4f}s "
                     f"critical={p['critical_stage']}"
                     + (f"  [{attr}]" if attr else ""))
    if metrics_snapshot:
        for name in ("engine.edges_per_sec", "engine.chunks_in_flight",
                     "engine.replication_state_bytes",
                     "halo.dcn_rows_aggregated", "halo.intra_rows"):
            m = metrics_snapshot.get(name)
            if m is None:
                continue
            val = m.get("value", 0)
            hi = f" (max {m['max']:g})" if "max" in m else ""
            lines.append(f"  {name:<34s} {val:g}{hi}")
    return "\n".join(lines)


@contextlib.contextmanager
def torch_profiler_session(log_dir: str | None, *, cuda: bool = True):
    """Capture a ``torch.profiler`` trace around the block — CPU activity,
    and with ``cuda`` the card's kernels and copies — and write it as a
    Chrome trace (``TORCH_TRACE_FILE``) into ``log_dir`` when the block
    ends; it complements the host-side span trace.  ``log_dir=None`` is a
    plain pass-through.  Asked for, the profiler is not optional: one that
    cannot start or export raises (the reference's hook falls back to a
    pass-through instead)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TORCH_TRACE_FILE))

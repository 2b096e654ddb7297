"""Exporters: Chrome trace-event JSON, Prometheus text, and trace analytics.

Counterpart of ``metrics_tpu/observability/export.py``. Three output
formats, one source each:

* :func:`to_chrome_trace` / :func:`write_chrome_trace` serialize an
  :class:`~metrics_tpu_torch.observability.tracer.EventTracer` buffer to the
  Chrome trace-event JSON *object format* (``{"traceEvents": [...]}``). The
  file loads in Perfetto (https://ui.perfetto.dev) and ``chrome://tracing``;
  the engines run their dispatches under ``torch.profiler.record_function``
  names (``metrics_tpu/<Owner>.<kind>``) while the tracer is on and a
  profiler records, so
  :func:`~metrics_tpu_torch.observability.shards.correlate_device_trace`
  lines the host spans up with a ``torch.profiler`` export of the same run.
* :func:`to_prometheus_text` / :func:`to_metrics_json` render an
  :class:`~metrics_tpu_torch.observability.instruments.InstrumentRegistry`
  snapshot in the Prometheus text exposition format or as a JSON document.
* :func:`summarize_trace` / :func:`diff_traces` / :func:`validate_chrome_trace`
  are the analytics behind ``python -m metrics_tpu_torch.observability``:
  per-event aggregates (count, total/mean/max duration), A-vs-B
  regressions, and a schema check.

Everything here is host-side stdlib: the CLI works on trace files from any
machine, without torch.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

from metrics_tpu_torch.observability import instruments as _instruments
from metrics_tpu_torch.observability import tracer as _tracer

TracerOrEvents = Union["_tracer.EventTracer", Sequence["_tracer.TraceEvent"]]

# required keys per Chrome trace-event phase we emit
_REQUIRED_KEYS = {"name", "ph", "ts", "pid", "tid"}
_VALID_PHASES = {"X", "i", "I", "M", "B", "E", "C"}  # accepted on input; we emit X/i/M


def _as_events(source: TracerOrEvents) -> List["_tracer.TraceEvent"]:
    if hasattr(source, "events"):
        return source.events()  # type: ignore[union-attr]
    return list(source)  # type: ignore[arg-type]


def _json_safe(value: Any) -> Any:
    """Args may carry numpy or torch scalars from the tallies — coerce to
    plain JSON types so the export never raises mid-dump."""
    if isinstance(value, dict):
        return {str(k): _json_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if hasattr(value, "item"):
        try:
            return value.item()
        except Exception:
            pass
    return str(value)


def to_chrome_trace(
    source: TracerOrEvents,
    process_name: str = "metrics_tpu",
    metadata: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Build the Chrome trace-event JSON object for a tracer's buffer.

    Emits one ``"X"`` (complete) or ``"i"`` (instant, thread scope) record per
    :class:`TraceEvent`, plus ``"M"`` metadata records naming the process and
    each thread track. ``pid`` is this process; ``tid`` is the recording
    thread, so async checkpoint writers get their own Perfetto track.
    """
    events = _as_events(source)
    pid = os.getpid()
    trace_events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "ts": 0, "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    seen_tids = set()
    for e in events:
        if e.tid not in seen_tids:
            seen_tids.add(e.tid)
            trace_events.append({
                "name": "thread_name", "ph": "M", "ts": 0, "pid": pid, "tid": e.tid,
                "args": {"name": f"host-{e.tid:x}"},
            })
        rec: Dict[str, Any] = {
            "name": e.name, "cat": e.cat, "ph": e.ph,
            "ts": e.ts, "pid": pid, "tid": e.tid,
        }
        if e.ph == _tracer.PH_COMPLETE:
            rec["dur"] = e.dur
        elif e.ph == _tracer.PH_INSTANT:
            rec["s"] = "t"  # thread-scoped instant
        if e.args:
            rec["args"] = _json_safe(e.args)
        trace_events.append(rec)
    doc: Dict[str, Any] = {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "metrics_tpu_torch.observability",
            "dropped_events": getattr(source, "dropped", 0) if hasattr(source, "dropped") else 0,
        },
    }
    if metadata:
        doc["otherData"].update(_json_safe(metadata))
    return doc


def write_chrome_trace(
    path: Union[str, "os.PathLike"],
    source: TracerOrEvents,
    process_name: str = "metrics_tpu",
    metadata: Optional[Dict[str, Any]] = None,
) -> str:
    """Serialize :func:`to_chrome_trace` to ``path``; returns the path."""
    doc = to_chrome_trace(source, process_name=process_name, metadata=metadata)
    path = os.fspath(path)
    with open(path, "w") as f:
        json.dump(doc, f, separators=(",", ":"))
    return path


def validate_chrome_trace(doc: Any) -> List[str]:
    """Schema check for a (parsed) Chrome trace-event JSON document.

    Returns a list of problems, empty when the document is valid Perfetto
    input: top-level ``traceEvents`` array (the object format), every record
    carrying the phase-appropriate required keys with sane types. Used by the
    test suite's round-trip check and the CLI ``validate`` subcommand.
    """
    problems: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["top level must be an object with a 'traceEvents' array"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' must be an array"]
    for i, rec in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(rec, dict):
            problems.append(f"{where}: not an object")
            continue
        missing = _REQUIRED_KEYS - set(rec)
        if missing:
            problems.append(f"{where}: missing keys {sorted(missing)}")
            continue
        ph = rec["ph"]
        if ph not in _VALID_PHASES:
            problems.append(f"{where}: unknown phase {ph!r}")
        if not isinstance(rec["name"], str):
            problems.append(f"{where}: 'name' must be a string")
        if not isinstance(rec["ts"], (int, float)):
            problems.append(f"{where}: 'ts' must be numeric")
        if ph == "X":
            if not isinstance(rec.get("dur"), (int, float)) or rec["dur"] < 0:
                problems.append(f"{where}: complete event needs numeric dur >= 0")
        if ph == "i" and rec.get("s") not in (None, "t", "p", "g"):
            problems.append(f"{where}: instant scope must be t/p/g")
        if "args" in rec and not isinstance(rec["args"], dict):
            problems.append(f"{where}: 'args' must be an object")
    return problems


# --------------------------------------------------------------------------- #
# Prometheus / JSON metrics snapshot
# --------------------------------------------------------------------------- #
def _escape_label(value: str) -> str:
    # exposition format: label values escape backslash, double-quote, newline
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(text: str) -> str:
    # HELP lines escape backslash and newline only (quotes are literal)
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(value: float) -> str:
    if value != value:  # NaN
        return "NaN"
    if value == float("inf"):
        return "+Inf"
    if value == float("-inf"):
        return "-Inf"
    return str(int(value)) if float(value).is_integer() else repr(float(value))


def to_prometheus_text(registry: Optional["_instruments.InstrumentRegistry"] = None) -> str:
    """Render the registry (default: the process registry) in the Prometheus
    text exposition format.

    Strictly to spec: one ``# HELP`` + ``# TYPE`` header
    per metric family, **all samples of a family contiguous** (engine samples
    arrive interleaved per-engine, so families are regrouped here), label
    values escaped (``\\``, ``"``, newline), and ``+Inf``/``-Inf``/``NaN``
    rendered the way Prometheus spells them.
    """
    reg = registry if registry is not None else _instruments.get_registry()
    # group samples into families, preserving first-seen family order
    families: List[str] = []
    by_family: Dict[str, List] = {}
    kinds: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    for s in reg.samples():
        family, kind = s.name, s.kind
        if kind.startswith("histogram"):
            family = s.name.rsplit("_", 1)[0]
            kind = "histogram"
        if family not in by_family:
            families.append(family)
            by_family[family] = []
            kinds[family] = kind
        by_family[family].append(s)
        if s.help and family not in helps:
            helps[family] = s.help
    lines: List[str] = []
    for family in families:
        help_text = helps.get(family, f"metrics_tpu sample family {family}.")
        lines.append(f"# HELP {family} {_escape_help(help_text)}")
        lines.append(f"# TYPE {family} {kinds[family]}")
        for s in by_family[family]:
            lines.append(f"{s.name}{_fmt_labels(s.labels)} {_fmt_value(s.value)}")
    return "\n".join(lines) + ("\n" if lines else "")


def to_metrics_json(registry: Optional["_instruments.InstrumentRegistry"] = None) -> Dict[str, Any]:
    """JSON metrics snapshot: ``{name: [{labels, value, kind}, ...]}``."""
    reg = registry if registry is not None else _instruments.get_registry()
    return reg.snapshot()


# --------------------------------------------------------------------------- #
# trace analytics (CLI backends)
# --------------------------------------------------------------------------- #
def load_trace(path: Union[str, "os.PathLike"]) -> Dict[str, Any]:
    with open(os.fspath(path)) as f:
        return json.load(f)


def _data_events(doc: Dict[str, Any]) -> Iterable[Dict[str, Any]]:
    for rec in doc.get("traceEvents", []):
        if isinstance(rec, dict) and rec.get("ph") != "M":
            yield rec


def summarize_trace(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Per-event-name aggregates over a Chrome trace document.

    Returns ``{"events": {name: {count, total_us, mean_us, max_us, cat}},
    "span_us", "total_events", "dropped"}`` — the number a human wants first
    when asking "where did this step's 40 ms go".
    """
    per: Dict[str, Dict[str, Any]] = {}
    ts_min: Optional[float] = None
    ts_max: Optional[float] = None
    n = 0
    for rec in _data_events(doc):
        n += 1
        name = rec["name"]
        dur = float(rec.get("dur", 0))
        ts = float(rec["ts"])
        ts_min = ts if ts_min is None else min(ts_min, ts)
        ts_max = max(ts_max if ts_max is not None else ts, ts + dur)
        agg = per.setdefault(name, {
            "count": 0, "total_us": 0.0, "max_us": 0.0, "cat": rec.get("cat", ""),
        })
        agg["count"] += 1
        agg["total_us"] += dur
        agg["max_us"] = max(agg["max_us"], dur)
    for agg in per.values():
        agg["mean_us"] = agg["total_us"] / agg["count"] if agg["count"] else 0.0
    return {
        "events": dict(sorted(per.items(), key=lambda kv: -kv[1]["total_us"])),
        "span_us": (ts_max - ts_min) if n else 0.0,
        "total_events": n,
        "dropped": doc.get("otherData", {}).get("dropped_events", 0),
    }


def diff_traces(doc_a: Dict[str, Any], doc_b: Dict[str, Any]) -> Dict[str, Any]:
    """Compare two trace summaries, B relative to A.

    Per event name: count/total-duration deltas plus ``total_ratio``
    (``b_total / a_total``, ``None`` when A has no time in that event).
    Events present on only one side are listed under ``only_a``/``only_b`` —
    the usual smoking gun (a fallback event appearing in B that A never had).
    """
    sa, sb = summarize_trace(doc_a), summarize_trace(doc_b)
    ea, eb = sa["events"], sb["events"]
    out: Dict[str, Any] = {
        "only_a": sorted(set(ea) - set(eb)),
        "only_b": sorted(set(eb) - set(ea)),
        "events": {},
        "span_us": {"a": sa["span_us"], "b": sb["span_us"]},
    }
    for name in sorted(set(ea) & set(eb)):
        a, b = ea[name], eb[name]
        out["events"][name] = {
            "count": {"a": a["count"], "b": b["count"], "delta": b["count"] - a["count"]},
            "total_us": {
                "a": a["total_us"], "b": b["total_us"],
                "delta": b["total_us"] - a["total_us"],
            },
            "total_ratio": (b["total_us"] / a["total_us"]) if a["total_us"] else None,
        }
    return out

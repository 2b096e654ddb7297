"""``python -m metrics_tpu_torch.observability`` — trace-file tooling.

Counterpart of ``python -m metrics_tpu.observability``, the same subcommands.

Subcommands (all operate on Chrome trace-event JSON files written by
:func:`metrics_tpu_torch.observability.write_chrome_trace`, and accept any
object-format Chrome trace):

* ``dump FILE [--cat CAT] [--name SUBSTR] [--limit N]`` — print events as a
  table (ts, dur, name, category, args), optionally filtered.
* ``summarize FILE [--json]`` — per-event-name aggregates: count, total /
  mean / max duration, sorted by total time.
* ``diff A B [--json]`` — compare two traces: per-event count and duration
  deltas, plus events present on only one side.
* ``validate FILE`` — schema-check the file as Perfetto input; exit 1 with
  the problem list when invalid.
* ``merge OUT SHARD [SHARD ...] [--device-trace FILE]`` — merge per-host
  trace shards (``shards.write_trace_shard`` / the server's ``/trace``
  endpoint) into one clock-aligned multi-host Perfetto trace; with
  ``--device-trace``, correlate the merged host timeline with a device-side
  profile export on the way out.
* ``regress FILE [FILE ...]`` — the bench regression watchdog: judge the
  newest ``BENCH_r*.json`` round against the rolling per-key baseline of the
  earlier rounds; exit 1 on regression (``--all`` replays every round).

Pure stdlib: runs anywhere, no torch needed on the analysis machine.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from metrics_tpu_torch.observability import export as _export
from metrics_tpu_torch.observability import regress as _regress
from metrics_tpu_torch.observability import shards as _shards


def _cmd_dump(ns: argparse.Namespace) -> int:
    doc = _export.load_trace(ns.file)
    rows: List[Dict[str, Any]] = []
    for rec in doc.get("traceEvents", []):
        if not isinstance(rec, dict) or rec.get("ph") == "M":
            continue
        if ns.cat and rec.get("cat") != ns.cat:
            continue
        if ns.name and ns.name not in rec.get("name", ""):
            continue
        rows.append(rec)
    rows.sort(key=lambda r: r.get("ts", 0))
    if ns.limit:
        rows = rows[: ns.limit]
    if ns.json:
        json.dump(rows, sys.stdout, indent=2)
        print()
        return 0
    t0 = rows[0]["ts"] if rows else 0
    print(f"{'t+us':>12}  {'dur_us':>9}  {'ph':>2}  {'cat':<11} name / args")
    for rec in rows:
        args = rec.get("args", {})
        arg_str = " " + json.dumps(args, separators=(",", ":")) if args else ""
        print(
            f"{rec['ts'] - t0:>12}  {rec.get('dur', ''):>9}  {rec['ph']:>2}  "
            f"{rec.get('cat', ''):<11} {rec['name']}{arg_str}"
        )
    print(f"-- {len(rows)} events" + (f" (of {ns.limit}+ shown)" if ns.limit else ""))
    return 0


def _cmd_summarize(ns: argparse.Namespace) -> int:
    summary = _export.summarize_trace(_export.load_trace(ns.file))
    if ns.json:
        json.dump(summary, sys.stdout, indent=2)
        print()
        return 0
    print(
        f"{summary['total_events']} events over {summary['span_us'] / 1e3:.3f} ms"
        + (f" ({summary['dropped']} dropped)" if summary["dropped"] else "")
    )
    print(f"{'count':>7}  {'total_us':>10}  {'mean_us':>9}  {'max_us':>9}  {'cat':<11} name")
    for name, agg in summary["events"].items():
        print(
            f"{agg['count']:>7}  {agg['total_us']:>10.0f}  {agg['mean_us']:>9.1f}  "
            f"{agg['max_us']:>9.0f}  {agg['cat']:<11} {name}"
        )
    return 0


def _cmd_diff(ns: argparse.Namespace) -> int:
    diff = _export.diff_traces(_export.load_trace(ns.a), _export.load_trace(ns.b))
    if ns.json:
        json.dump(diff, sys.stdout, indent=2)
        print()
        return 0
    span = diff["span_us"]
    print(f"span: {span['a'] / 1e3:.3f} ms -> {span['b'] / 1e3:.3f} ms")
    for side, names in (("only in A", diff["only_a"]), ("only in B", diff["only_b"])):
        if names:
            print(f"{side}: {', '.join(names)}")
    print(f"{'count A>B':>12}  {'total_us A':>11}  {'total_us B':>11}  {'ratio':>7}  name")
    for name, d in sorted(
        diff["events"].items(),
        key=lambda kv: -abs(kv[1]["total_us"]["delta"]),
    ):
        ratio = d["total_ratio"]
        print(
            f"{d['count']['a']:>5}>{d['count']['b']:<6}  {d['total_us']['a']:>11.0f}  "
            f"{d['total_us']['b']:>11.0f}  {ratio if ratio is None else format(ratio, '>7.2f')}  {name}"
        )
    return 0


def _cmd_validate(ns: argparse.Namespace) -> int:
    try:
        doc = _export.load_trace(ns.file)
    except (OSError, json.JSONDecodeError) as err:
        print(f"{ns.file}: unreadable ({err})", file=sys.stderr)
        return 1
    problems = _export.validate_chrome_trace(doc)
    if problems:
        for p in problems:
            print(f"{ns.file}: {p}", file=sys.stderr)
        return 1
    n = sum(1 for r in doc["traceEvents"] if isinstance(r, dict) and r.get("ph") != "M")
    print(f"{ns.file}: valid ({n} events)")
    return 0


def _cmd_merge(ns: argparse.Namespace) -> int:
    doc = _shards.merge_trace_shards(ns.shards)
    if ns.device_trace:
        doc = _shards.correlate_device_trace(doc, _export.load_trace(ns.device_trace))
    problems = _export.validate_chrome_trace(doc)
    if problems:  # merge output must always be valid Perfetto input
        for p in problems:
            print(f"merge produced invalid trace: {p}", file=sys.stderr)
        return 2
    with open(ns.out, "w") as fh:
        json.dump(doc, fh, separators=(",", ":"))
    other = doc.get("otherData", {})
    n = sum(1 for r in doc["traceEvents"] if r.get("ph") != "M")
    line = f"{ns.out}: {n} events from hosts {other.get('merged_hosts', [])}"
    if other.get("unaligned"):
        line += f" (unaligned: {other['unaligned']})"
    if "correlation" in other:
        c = other["correlation"]
        line += (f"; correlated {c['matched']}/{c['host_dispatches']} dispatch spans "
                 f"with {c['device_annotations']} device annotations")
    print(line)
    return 0


def _cmd_regress(ns: argparse.Namespace) -> int:
    report = _regress.check_paths(
        ns.files,
        threshold_pct=ns.threshold_pct,
        pct_points=ns.pct_points,
        window=ns.window,
        min_history=ns.min_history,
        all_rounds=ns.all,
    )
    if ns.json:
        json.dump(report.to_dict(), sys.stdout, indent=2)
        print()
    else:
        for name, note in sorted(report.notes.items()):
            print(f"note: {name}: {note}", file=sys.stderr)
        for r in report.regressions:
            print(f"REGRESSION {r.describe()}")
        print(
            f"rounds {', '.join(report.checked_rounds) or '(none)'}: "
            f"{report.keys_checked} watched key(s) checked, "
            f"{report.keys_skipped_no_history} without history, "
            f"{len(report.regressions)} regression(s)"
        )
    if not report.checked_rounds:
        print("no parseable bench round to judge", file=sys.stderr)
        return 2
    return 0 if report.ok else 1


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m metrics_tpu_torch.observability",
        description="Inspect Chrome trace-event JSON files from the metrics_tpu tracer.",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("dump", help="print events of a trace file")
    p.add_argument("file")
    p.add_argument("--cat", help="only events of this category")
    p.add_argument("--name", help="only events whose name contains this substring")
    p.add_argument("--limit", type=int, default=0, help="show at most N events")
    p.add_argument("--json", action="store_true", help="emit JSON instead of a table")
    p.set_defaults(fn=_cmd_dump)

    p = sub.add_parser("summarize", help="per-event aggregates of a trace file")
    p.add_argument("file")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_summarize)

    p = sub.add_parser("diff", help="compare two trace files (B relative to A)")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_diff)

    p = sub.add_parser("validate", help="schema-check a trace file as Perfetto input")
    p.add_argument("file")
    p.set_defaults(fn=_cmd_validate)

    p = sub.add_parser("merge", help="merge per-host trace shards into one Perfetto trace")
    p.add_argument("out", help="output trace file")
    p.add_argument("shards", nargs="+", help="shard files (shards.write_trace_shard / GET /trace)")
    p.add_argument(
        "--device-trace",
        help="torch.profiler Chrome-trace export to correlate via the record_function names",
    )
    p.set_defaults(fn=_cmd_merge)

    p = sub.add_parser(
        "regress", help="bench regression watchdog over BENCH_r*.json rounds"
    )
    p.add_argument("files", nargs="+", help="bench round files, any order")
    p.add_argument(
        "--threshold-pct", type=float, default=_regress.DEFAULT_THRESHOLD_PCT,
        help="ratio regression threshold for duration/throughput keys "
        f"(default {_regress.DEFAULT_THRESHOLD_PCT:g}%%)",
    )
    p.add_argument(
        "--pct-points", type=float, default=_regress.DEFAULT_PCT_POINTS,
        help="absolute threshold for *_pct keys, in percentage points "
        f"(default {_regress.DEFAULT_PCT_POINTS:g})",
    )
    p.add_argument(
        "--window", type=int, default=_regress.DEFAULT_WINDOW,
        help=f"rolling-baseline window in rounds (default {_regress.DEFAULT_WINDOW})",
    )
    p.add_argument(
        "--min-history", type=int, default=_regress.DEFAULT_MIN_HISTORY,
        help="earlier observations a key needs before it is judged "
        f"(default {_regress.DEFAULT_MIN_HISTORY})",
    )
    p.add_argument(
        "--all", action="store_true",
        help="judge every round against its predecessors, not just the newest",
    )
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_regress)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    ns = build_parser().parse_args(argv)
    return ns.fn(ns)


if __name__ == "__main__":
    sys.exit(main())

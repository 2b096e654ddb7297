"""Bench regression watchdog: longitudinal checks over ``BENCH_r*.json``.

Counterpart of ``metrics_tpu/observability/regress.py``, the same rules.

Every bench round this repo records is a JSON document — either the bench's
own record (``{"metric", "value", "unit", "extra": {...}}``) or a run
wrapper (``{"n", "cmd", "rc", "tail"}`` with the record as the last JSON line
of ``tail``, possibly surrounded by platform log noise). Nothing consumed
them longitudinally until now, so a perf regression — the fused-update
streak slowing down, the bucketed collectives' byte tallies growing — would
ship silently.

:func:`check_trajectory` parses the rounds in order, flattens every numeric
leaf to a dot path (``extra.config2_collection_1k.fused_update.
fused_update_us_per_step``), and compares each **watched** key of the round
under test against a *rolling baseline*: the median of that key's values over
the most recent ``window`` earlier rounds that recorded it. A key regresses
when it moves past the threshold in its bad direction:

* duration/size keys (``*_us``, ``*_us_per_step``, ``*_ms``, ``*_s``,
  ``*_seconds``, ``*_bytes``) — lower is better, ratio threshold
  (``threshold_pct``, default 50%: the repo's CPU rounds run on whatever
  host is free, and cross-host swings of ±15% are routine —
  see r06→r08's fused-update numbers — so the default only fires on
  step-change regressions, not machine drift);
* throughput keys (``*_per_sec``, ``*speedup``) — higher is better, same
  ratio threshold;
* percentage keys (``*_pct``) — compared in absolute points
  (``pct_points``, default 10.0), because ratios are meaningless near zero
  (an overhead going 0.5% → 1.5% is a 3x ratio and still noise);
* everything else (counts, flags, configuration echoes) — unwatched.

By default only the **newest** round is judged (the ``bench.py`` self-check:
"did the round I just recorded regress?"). ``all_rounds=True`` replays the
whole trajectory — useful for exploration, but early rounds legitimately
redefine what their headline measures, so it is not the gating mode.

CLI (exit 1 on regression, 2 on unreadable input)::

    python -m metrics_tpu_torch.observability regress BENCH_r*.json
    python -m metrics_tpu_torch.observability regress --threshold-pct 30 --json BENCH_r*.json

Pure stdlib: runs on any machine that can see the JSON files.
"""
from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

DEFAULT_THRESHOLD_PCT = 50.0
DEFAULT_PCT_POINTS = 10.0
DEFAULT_WINDOW = 5
DEFAULT_MIN_HISTORY = 1

LOWER_IS_BETTER = "lower"
HIGHER_IS_BETTER = "higher"
PCT_POINTS = "pct_points"

# watched-key classification, first match wins (checked against the last
# path segment, lowercased). mfu before the generic _pct rule: an MFU
# percentage is a throughput, not an overhead.
_WATCH_RULES: Tuple[Tuple[re.Pattern, str], ...] = (
    (re.compile(r"mfu_pct$"), HIGHER_IS_BETTER),
    (re.compile(r"(^|_)pct(_min|_max|_iqr)?$"), PCT_POINTS),
    (re.compile(r"_(per_sec|per_second)$"), HIGHER_IS_BETTER),
    (re.compile(r"(^|_)speedup$"), HIGHER_IS_BETTER),
    (re.compile(r"_(us|us_per_step|ms|s|sec|seconds|wall_s|bytes)$"), LOWER_IS_BETTER),
)


def classify_key(path: str) -> Optional[str]:
    """Direction for a flattened key path, or ``None`` when unwatched."""
    segment = path.rsplit(".", 1)[-1].lower()
    for pattern, direction in _WATCH_RULES:
        if pattern.search(segment):
            return direction
    return None


# --------------------------------------------------------------------------- #
# round loading
# --------------------------------------------------------------------------- #
_RECORD_LINE_RE = re.compile(r'\{"metric"')


@dataclass
class Round:
    name: str                      # "r06"
    path: str
    record: Optional[Dict[str, Any]]   # None => unparseable (carried as a note)
    note: str = ""

    @property
    def ok(self) -> bool:
        return self.record is not None


def _extract_record(doc: Any) -> Tuple[Optional[Dict[str, Any]], str]:
    """The bench record inside a round file, whichever wrapper it wears."""
    if not isinstance(doc, dict):
        return None, "not a JSON object"
    if "metric" in doc:
        return doc, ""
    tail = doc.get("tail")
    if not isinstance(tail, str):
        return None, "no 'metric' key and no 'tail' wrapper"
    # the record is the last parseable {"metric"...} line; wrapper tails mix
    # in platform warnings and may truncate the head of the buffer
    found = None
    for line in tail.splitlines():
        m = _RECORD_LINE_RE.search(line)
        if m is None:
            continue
        try:
            found = json.loads(line[m.start():])
        except json.JSONDecodeError:
            continue
    if found is None:
        return None, "tail carries no parseable bench record line"
    return found, ""


def round_name(path: str) -> str:
    base = os.path.basename(os.fspath(path))
    m = re.search(r"(r\d+)", base)
    return m.group(1) if m else os.path.splitext(base)[0]


def load_rounds(paths: Sequence[Union[str, "os.PathLike"]]) -> List[Round]:
    """Load and order the trajectory (by round number, then name)."""
    rounds: List[Round] = []
    for path in paths:
        path = os.fspath(path)
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except (OSError, json.JSONDecodeError) as err:
            rounds.append(Round(round_name(path), path, None, f"unreadable: {err}"))
            continue
        record, note = _extract_record(doc)
        rounds.append(Round(round_name(path), path, record, note))

    def sort_key(r: Round) -> Tuple:
        m = re.match(r"r(\d+)$", r.name)
        return (0, int(m.group(1))) if m else (1, r.name)

    rounds.sort(key=sort_key)
    return rounds


def flatten_record(record: Dict[str, Any]) -> Dict[str, float]:
    """Numeric leaves of a bench record as ``{dot.path: value}``.

    Only ``value`` (the headline) and the ``extra`` tree are walked — the
    wrapper's bookkeeping (``rc``, ``n``, ``vs_baseline`` nulls) stays out. The
    headline lands under the path ``value.<metric-name>`` so its direction
    classifies off the metric's own name (``..._us_per_step``, ``..._pct``).
    """
    out: Dict[str, float] = {}

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, bool) or node is None:
            return
        if isinstance(node, (int, float)):
            out[prefix] = float(node)
            return
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else str(k), v)

    value = record.get("value")
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        out[f"value.{record.get('metric', 'headline')}"] = float(value)
    walk("extra", record.get("extra", {}))
    return out


# --------------------------------------------------------------------------- #
# the check
# --------------------------------------------------------------------------- #
@dataclass
class Regression:
    round: str
    key: str
    value: float
    baseline: float
    direction: str
    delta: float          # ratio pct for ratio keys, points for pct keys
    history: List[float] = field(default_factory=list)

    def describe(self) -> str:
        unit = "points" if self.direction == PCT_POINTS else "%"
        return (
            f"{self.round}: {self.key} = {self.value:g} vs rolling baseline "
            f"{self.baseline:g} ({self.delta:+.1f} {unit}, "
            f"{'lower' if self.direction != HIGHER_IS_BETTER else 'higher'} is better; "
            f"history {['%g' % h for h in self.history]})"
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "round": self.round, "key": self.key, "value": self.value,
            "baseline": self.baseline, "direction": self.direction,
            "delta": round(self.delta, 3), "history": self.history,
        }


@dataclass
class RegressReport:
    regressions: List[Regression] = field(default_factory=list)
    checked_rounds: List[str] = field(default_factory=list)
    keys_checked: int = 0
    keys_skipped_no_history: int = 0
    notes: Dict[str, str] = field(default_factory=dict)
    config: Dict[str, float] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.regressions

    def to_dict(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "regressions": [r.to_dict() for r in self.regressions],
            "checked_rounds": self.checked_rounds,
            "keys_checked": self.keys_checked,
            "keys_skipped_no_history": self.keys_skipped_no_history,
            "notes": self.notes,
            "config": self.config,
        }


def _median(values: Sequence[float]) -> float:
    ordered = sorted(values)
    n = len(ordered)
    mid = n // 2
    return ordered[mid] if n % 2 else (ordered[mid - 1] + ordered[mid]) / 2.0


def _judge(
    key: str,
    value: float,
    history: List[float],
    direction: str,
    threshold_pct: float,
    pct_points: float,
    window: int,
) -> Optional[Tuple[float, float]]:
    """(baseline, delta) when ``value`` regresses, else ``None``."""
    recent = history[-window:]
    baseline = _median(recent)
    if direction == PCT_POINTS:
        delta = value - baseline
        return (baseline, delta) if delta > pct_points else None
    if abs(baseline) < 1e-12:
        return None  # ratio against ~zero is noise, not signal
    change_pct = (value / baseline - 1.0) * 100.0
    if direction == LOWER_IS_BETTER and change_pct > threshold_pct:
        return baseline, change_pct
    if direction == HIGHER_IS_BETTER and change_pct < -threshold_pct:
        return baseline, change_pct
    return None


def check_trajectory(
    rounds: Sequence[Round],
    threshold_pct: float = DEFAULT_THRESHOLD_PCT,
    pct_points: float = DEFAULT_PCT_POINTS,
    window: int = DEFAULT_WINDOW,
    min_history: int = DEFAULT_MIN_HISTORY,
    all_rounds: bool = False,
) -> RegressReport:
    """Judge the newest round (or, with ``all_rounds``, every round) against
    its rolling per-key baseline. See the module docstring for semantics."""
    report = RegressReport(config={
        "threshold_pct": threshold_pct, "pct_points": pct_points,
        "window": window, "min_history": min_history,
    })
    history: Dict[str, List[float]] = {}
    parsed = [r for r in rounds if r.ok]
    for r in rounds:
        if not r.ok:
            report.notes[r.name] = r.note
    if not parsed:
        return report
    judged = parsed if all_rounds else parsed[-1:]
    judged_names = {r.name for r in judged}

    for r in parsed:
        flat = flatten_record(r.record)  # type: ignore[arg-type]
        if r.name in judged_names:
            report.checked_rounds.append(r.name)
            for key, value in sorted(flat.items()):
                direction = classify_key(key)
                if direction is None:
                    continue
                past = history.get(key, ())
                if len(past) < min_history:
                    report.keys_skipped_no_history += 1
                    continue
                report.keys_checked += 1
                verdict = _judge(key, value, list(past), direction,
                                 threshold_pct, pct_points, window)
                if verdict is not None:
                    baseline, delta = verdict
                    report.regressions.append(Regression(
                        round=r.name, key=key, value=value, baseline=baseline,
                        direction=direction, delta=delta,
                        history=list(past)[-window:],
                    ))
        for key, value in flat.items():
            history.setdefault(key, []).append(value)
    return report


def check_paths(
    paths: Sequence[Union[str, "os.PathLike"]],
    **kwargs: Any,
) -> RegressReport:
    """:func:`check_trajectory` over round files (the API behind the CLI and
    the ``bench.py`` self-check)."""
    return check_trajectory(load_rounds(paths), **kwargs)

"""The port's observability layer (``metrics_tpu_torch.observability``) against the JAX package's.

Each scenario runs the same seeded numpy inputs through both packages under
their tracers and compares the multiset of ``(name, category)`` of the
events and the count of each ``dispatch/*`` event (names, not times or
args). The JAX side of every scenario runs once per module (the
``jax_events`` fixture, engines at their defaults where the dispatch events
are compared). Sync scenarios run the port in a ``gloo`` world of one rank
in this process and the JAX package under ``jax.make_jaxpr`` with an axis
of one, where its sync runs at trace time.

Beside them: the Chrome export validates in both packages' checkers, the
Prometheus text passes the JAX suite's strict parser with the JAX package's
sample names, label keys and types (the autotune gauges aside: the port has
no autotune yet), the scrape server (marked ``network``), the correlation
of a CPU ``torch.profiler`` export with the host spans, the trace shards,
and the regression watchdog and CLI against the JAX package's on synthetic
rounds.
"""
import collections
import json
import re
import subprocess
import sys
import urllib.error
import urllib.request
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import metrics_tpu as mj
import metrics_tpu_torch as mt
from metrics_tpu import observability as jobs
from metrics_tpu.observability import instruments as jinst
from metrics_tpu_torch import observability as tobs
from metrics_tpu_torch.observability import instruments as tinst
from metrics_tpu_torch.observability import tracer as ttracer
from tests.observability.test_exporters import _StrictPromParser

pytestmark = [pytest.mark.filterwarnings("ignore::UserWarning"), pytest.mark.usefixtures("one_torch_thread")]
from tests.helpers.torch_port import one_torch_thread  # noqa: E402,F401  (the fixture)

C, BATCH, STEPS = 6, 16, 4
DISPATCH = ("dispatch/eager", "dispatch/compile", "dispatch/cached", "dispatch/fallback")


def _batches(seed=0, steps=STEPS):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(BATCH, C)).astype(np.float32), rng.integers(0, C, BATCH).astype(np.int32))
            for _ in range(steps)]


class _Jax:
    mt, obs = mj, jobs

    @staticmethod
    def arr(x):
        return jnp.asarray(x)

    @staticmethod
    def kw(**kw):
        return kw


class _Torch:
    mt, obs = mt, tobs

    @staticmethod
    def arr(x):
        return torch.from_numpy(np.asarray(x))

    @staticmethod
    def kw(**kw):
        return dict(kw, device="cpu")


def _config2(side, **flags):
    coll_flags = {k: v for k, v in flags.items() if k != "member"}
    member = flags.get("member", {})
    return side.mt.MetricCollection(
        {
            "acc": side.mt.Accuracy(num_classes=C, average="micro", **side.kw(**member)),
            "f1": side.mt.F1Score(num_classes=C, average="macro", **side.kw(**member)),
            "precision": side.mt.Precision(num_classes=C, average="macro", **side.kw(**member)),
            "recall": side.mt.Recall(num_classes=C, average="macro", **side.kw(**member)),
        },
        **coll_flags,
    )


def _feed(side, metric, steps=STEPS, seed=0):
    for logits, target in _batches(seed, steps):
        metric.update(side.arr(logits), side.arr(target))


def _config2_run(flags):
    def run(side, ctx):
        coll = _config2(side, **flags)
        _feed(side, coll)
        coll.compute()
        ctx.append(coll)

    return run


def _accuracy_run(side, ctx):
    m = side.mt.Accuracy(**side.kw())
    _feed(side, m)
    m.compute()
    ctx.append(m)


def _overflow_run(side, ctx):
    m = side.mt.CatMetric(**side.kw(buffer_capacity=8))
    for _ in range(4):
        m.update(side.arr(np.arange(4, dtype=np.float32)))
    ctx.append(m)


def _states(side, coll):
    states = coll.init_state()
    for logits, target in _batches(1):
        states = coll.update_state(states, side.arr(logits), side.arr(target))
    return states


def _refusing(coll):
    """Every leader's counts sync through int8 under a budget the gate refuses."""
    for name in ("acc", "f1"):
        leader = coll[name]
        leader._sync_transports = {s: "int8" for s in ("tp", "fp", "tn", "fn")}
        leader._sync_tolerances = {"tp": 1e-12}


def _synced_run(side, ctx):
    coll = _config2(side)
    _refusing(coll)
    states = _states(side, coll)
    if side is _Jax:
        jax.make_jaxpr(lambda s: coll.sync_compute_state(s, "data"), axis_env=[("data", 1)])(states)
    else:
        coll.sync_compute_state(states, dist.group.WORLD)


def _incremental_run(side, ctx):
    coll = _config2(side)
    states = _states(side, coll)
    batches = _batches(2)
    side.mt.parallel.set_sync_mode("incremental")
    try:
        if side is _Jax:
            def streak(st):
                carry = coll.init_incremental(st, sync_every=2)
                for logits, target in batches:
                    carry = coll.update_state_incremental(carry, jnp.asarray(logits), jnp.asarray(target),
                                                          axis_name="data")
                return coll.finalize_incremental(carry, "data")

            jax.make_jaxpr(streak, axis_env=[("data", 1)])(states)
        else:
            carry = coll.init_incremental(states, sync_every=2)
            for logits, target in batches:
                carry = coll.update_state_incremental(carry, torch.from_numpy(logits), torch.from_numpy(target),
                                                      group=dist.group.WORLD)
            coll.finalize_incremental(carry, dist.group.WORLD)
    finally:
        side.mt.parallel.set_sync_mode(None)


def _shard_run(side, ctx):
    mesh = side.mt.parallel.make_mesh([1], ["data"])
    m = side.mt.F1Score(num_classes=C, average="macro", **side.kw())
    _feed(side, m, steps=1)
    m.shard_state(mesh)
    m.unshard_state()
    ctx.append(m)


SCENARIOS = {
    "config2_fused": _config2_run({}),
    "config2_unfused": _config2_run({"fused_update": False}),
    "config2_eager": _config2_run({"compiled_update": False, "compiled_compute": False,
                                   "member": {"compiled_update": False, "compiled_compute": False}}),
    "accuracy": _accuracy_run,
    "synced_int8_refused": _synced_run,
    "incremental_streak": _incremental_run,
    "shard_mesh_of_one": _shard_run,
    "catbuffer_overflow": _overflow_run,
}


def _traced(side, run):
    """The scenario's events as (multiset of (name, cat), dispatch counts)."""
    ctx = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with side.obs.trace() as tracer:
            run(side, ctx)
        events = tracer.events()
    pairs = collections.Counter((e.name, e.cat) for e in events)
    return pairs, {name: sum(1 for e in events if e.name == name) for name in DISPATCH}


@pytest.fixture(scope="module")
def world1():
    """A gloo world of one rank in this process (the port's side of the sync scenarios)."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_events():
    return {name: _traced(_Jax, run) for name, run in SCENARIOS.items()}


@pytest.fixture(autouse=True)
def _tracing_off_after():
    yield
    for obs, tracer in ((tobs, ttracer), (jobs, jobs.tracer)):
        obs.disable()
        if tracer.get_tracer() is not None:
            tracer.get_tracer().clear()
        obs.shutdown()


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_event_parity(scenario, jax_events, world1):
    want_pairs, want_dispatch = jax_events[scenario]
    got_pairs, got_dispatch = _traced(_Torch, SCENARIOS[scenario])
    assert got_pairs == want_pairs
    assert got_dispatch == want_dispatch
    # the eager series runs no engine, dispatcher or sync: nothing to record
    assert (sum(want_pairs.values()) == 0) == (scenario == "config2_eager")


def test_the_catalog_is_the_jax_packages():
    assert tobs.EVENT_CATALOG == jobs.EVENT_CATALOG
    emitted = {name for names in tobs.EVENT_CATALOG.values() for name in names}
    assert set(DISPATCH) <= emitted


def test_tracing_is_off_by_default_and_records_nothing():
    assert not tobs.enabled() and not ttracer.active
    before = len(ttracer.get_tracer() or ())
    _config2_run({})(_Torch, [])
    assert len(ttracer.get_tracer() or ()) == before


def test_hooks_off_add_no_host_read_to_a_dispatch():
    """With the tracer, chaos and guard off, a steady-state dispatch reads
    nothing back to the host (no ``_local_scalar_dense``, ``tolist`` or copy
    to the CPU), as before the hooks; with them on, the guard's one read per
    boundary is all that is added."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Reads(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._overloadpacket is torch.ops.aten._local_scalar_dense:
                self.n += 1
            return func(*args, **(kwargs or {}))

    coll = _config2(_Torch)
    batches = _batches(3, steps=4)
    for logits, target in batches[:3]:
        coll.update(torch.from_numpy(logits), torch.from_numpy(target))
    with Reads() as reads:
        coll.update(*map(torch.from_numpy, batches[3]))
    assert coll._update_engine.stats.cache_hits == 2  # calls 3 and 4 replayed
    assert reads.n == 0


def test_chrome_export_validates_in_both_packages(tmp_path):
    with tobs.trace() as tracer:
        _config2_run({})(_Torch, [])
    doc = tobs.to_chrome_trace(tracer)
    assert tobs.validate_chrome_trace(doc) == [] == jobs.validate_chrome_trace(doc)
    path = tobs.write_chrome_trace(tmp_path / "run.trace.json", tracer)
    assert tobs.load_trace(path) == json.loads(json.dumps(doc))
    summary = tobs.summarize_trace(doc)
    assert summary["events"]["dispatch/cached"]["count"] == 2
    assert summary == jobs.summarize_trace(doc)
    assert tobs.diff_traces(doc, doc) == jobs.diff_traces(doc, doc)
    cli = subprocess.run([sys.executable, "-m", "metrics_tpu_torch.observability", "validate", path],
                         capture_output=True, text=True, timeout=60)
    assert cli.returncode == 0 and "valid" in cli.stdout, cli.stderr


def _exposition(side, inst, world1):
    """The registry's text after one run of each kind of series: engines,
    partitions, sync bytes and a refusal, a buffer overflow, the tracer."""
    inst.REGISTRY.clear()
    keep = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with side.obs.trace():
            _config2_run({})(side, keep)
            _synced_run(side, keep)
            _overflow_run(side, keep)
    return side.obs.to_prometheus_text(), keep


def _families(text):
    families, samples = _StrictPromParser().parse(text)
    shapes = {(name, tuple(sorted(labels))) for name, labels, _ in samples}
    types = {name: info["type"] for name, info in families.items()}
    return shapes, types, samples


def test_prometheus_names_labels_and_types_equal_the_jax_packages(world1):
    jax_text, keep_j = _exposition(_Jax, jinst, world1)
    torch_text, keep_t = _exposition(_Torch, tinst, world1)
    j_shapes, j_types, j_samples = _families(jax_text)
    t_shapes, t_types, t_samples = _families(torch_text)
    assert t_shapes == j_shapes
    assert t_types == j_types
    for family in ("eager_calls", "cache_misses", "cache_hits"):
        name = f"metrics_tpu_engine_{family}"

        def values(samples):
            return sorted((tuple(sorted(labels.items())), value) for n, labels, value in samples if n == name)

        assert values(t_samples) == values(j_samples), family
    refusals = [s for s in t_samples if s[0] == "metrics_tpu_sync_transport_refusals_total"]
    assert refusals and refusals[0][1] == {"transport": "int8", "reason": "error_budget"}
    del keep_j, keep_t


def test_registry_instruments_behave_as_the_jax_packages():
    regs = (tinst.InstrumentRegistry(), jinst.InstrumentRegistry())
    for reg in regs:
        reg.counter("c_total", "a counter", op="x").inc(2)
        reg.gauge("g", "a gauge").set(3.5)
        h = reg.histogram("h_seconds", "a histogram", buckets=(0.1, 1.0), endpoint="/metrics")
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
    def manual(text):  # the process, tracer and autotune gauges aside
        return [line for line in text.splitlines() if re.search(r"metrics_tpu_(c_total|g|h_seconds(_bucket|_sum|_count)?)\b", line)]

    assert manual(tobs.to_prometheus_text(regs[0])) == manual(jobs.to_prometheus_text(regs[1]))
    assert len(manual(tobs.to_prometheus_text(regs[0]))) == 13  # 3 + 3 + HELP, TYPE, 3 buckets, sum, count
    snap = [tobs.to_metrics_json(r) for r in regs]
    assert [{k: v for k, v in d.items() if re.search(r"_(c_total|g|h_seconds\w*)$", k)} for d in snap] == [
        {k: v for k, v in snap[1].items() if re.search(r"_(c_total|g|h_seconds\w*)$", k)}] * 2
    with pytest.raises(TypeError):
        regs[0].gauge("c_total", op="x")
    with pytest.raises(ValueError):
        regs[0].counter("c_total", op="x").inc(-1)


def test_engine_stats_views_keep_their_shape():
    coll = _config2(_Torch)
    _feed(_Torch, coll)
    stats = coll.engine_stats()
    assert set(stats) == {"update", "compute", "fallback_reasons", "members", "partition"}
    assert stats["update"].cache_hits == 2 and stats["fallback_reasons"] == {}
    assert set(stats["members"]["acc"]) == {"update", "compute", "fallback_reasons", "partition"}
    assert coll._dispatcher in tinst.REGISTRY.live_dispatchers()
    assert coll._update_engine in tinst.REGISTRY.live_engines()


# --------------------------------------------------------------------------- #
# the scrape server
# --------------------------------------------------------------------------- #
def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read().decode()


@pytest.mark.network
def test_scrape_during_a_fused_streak_parses_strictly():
    tobs.enable()
    server = tobs.serve(port=0)
    assert server.host == "127.0.0.1" and server.port > 0 and tobs.get_server() is server
    coll = _config2(_Torch)
    bodies = []
    for logits, target in _batches(4, steps=5):
        coll.update(torch.from_numpy(logits), torch.from_numpy(target))
        bodies.append(_get(server.url + "/metrics"))
    status, ctype, text = bodies[-1]
    assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
    families, samples = _StrictPromParser().parse(text)
    hits = {labels["owner"]: v for n, labels, v in samples
            if n == "metrics_tpu_engine_cache_hits" and labels["kind"] == "update"}
    assert hits["MetricCollection"] == 3
    assert coll._members_stale  # the streak was not interrupted by the scrapes
    trace = json.loads(_get(server.url + "/trace")[2])
    assert tobs.validate_chrome_trace(trace) == [] and trace["otherData"]["shard"]["host_id"]
    health = json.loads(_get(server.url + "/healthz")[2])
    assert health["status"] == "ok" and health["tracing"] is True
    assert json.loads(_get(server.url + "/stats.json")[2])["metrics_tpu_engine_cache_hits"]
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(server.url + "/nope", timeout=10)
    assert exc.value.code == 404
    thread = server._thread
    tobs.shutdown()
    assert tobs.get_server() is None and not thread.is_alive()


@pytest.mark.network
def test_a_taken_port_falls_back_to_the_spool(tmp_path):
    first = tobs.ObservabilityServer(port=0).start()
    try:
        handle = tobs.serve(port=first.port, spool_dir=tmp_path / "spool")
        assert handle.kind == "spool" and "bind" in handle.reason
        tobs.enable()
        _accuracy_run(_Torch, [])
        path = handle.flush()
        merged = tobs.merge_spool_dir(tmp_path / "spool")
        assert path.endswith(".shard.json") and tobs.validate_chrome_trace(merged) == []
        assert any(r.get("name") == "dispatch/cached" for r in merged["traceEvents"])
    finally:
        tobs.shutdown()
        first.stop()
    with pytest.raises(OSError):
        taken = tobs.ObservabilityServer(port=0).start()
        try:
            tobs.serve(port=taken.port)
        finally:
            taken.stop()


@pytest.mark.network
def test_a_scrape_fault_is_a_500_not_a_crash():
    from metrics_tpu_torch.resilience import FaultSpec, chaos

    server = tobs.serve(port=0)
    with chaos.plan([FaultSpec("server/scrape", nth=1)]) as plan:
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(server.url + "/metrics", timeout=10)
        assert exc.value.code == 500 and b"ChaosError" in exc.value.read()
        assert _get(server.url + "/metrics")[0] == 200
    assert [(e.site, e.call) for e in plan.log] == [("server/scrape", 1)]
    text = _get(server.url + "/metrics")[2]
    assert 'metrics_tpu_chaos_faults_total{kind="error",site="server/scrape"}' in text
    assert 'metrics_tpu_obs_scrapes_total{endpoint="/metrics"}' in text


# --------------------------------------------------------------------------- #
# shards and the device-profile correlation
# --------------------------------------------------------------------------- #
def test_shards_merge_onto_one_clock(tmp_path):
    with tobs.trace() as tracer:
        _accuracy_run(_Torch, [])
    a = tobs.write_trace_shard(tmp_path, tracer, host_id="host-a")
    b = tobs.write_trace_shard(tmp_path, tracer, host_id="host-b")
    merged = tobs.merge_trace_shards([b, a])
    assert merged["otherData"]["merged_hosts"] == ["host-a", "host-b"] and merged["otherData"]["unaligned"] == []
    assert tobs.validate_chrome_trace(merged) == []
    jax_merged = jobs.merge_trace_shards([b, a])
    assert [r["name"] for r in merged["traceEvents"]] == [r["name"] for r in jax_merged["traceEvents"]]
    out = tmp_path / "merged.json"
    cli = subprocess.run([sys.executable, "-m", "metrics_tpu_torch.observability", "merge", str(out), a, b],
                         capture_output=True, text=True, timeout=60)
    assert cli.returncode == 0 and "host-a" in cli.stdout, cli.stderr
    assert tobs.parse_dispatch_annotation(tobs.dispatch_annotation("F1Score", "update")) == ("F1Score", "update")
    assert tobs.parse_dispatch_annotation("aten::add") is None


def test_a_cpu_profile_correlates_with_every_dispatch_span(tmp_path):
    """Every host ``dispatch/compile`` and ``dispatch/cached`` span of the run
    ran under its ``record_function``, which a CPU ``torch.profiler`` export
    shows as a ``user_annotation``: each is matched, in order."""
    from torch.profiler import ProfilerActivity, profile

    coll = _config2(_Torch, fused_update=False)
    with tobs.trace() as tracer, profile(activities=[ProfilerActivity.CPU]) as prof:
        _feed(_Torch, coll)
        coll.compute()
    prof.export_chrome_trace(str(tmp_path / "device.json"))
    device = tobs.load_trace(tmp_path / "device.json")
    names = {r["name"] for r in device["traceEvents"] if r.get("cat") == "user_annotation"}
    assert tobs.dispatch_annotation("F1Score", "update") in names
    host = tobs.to_chrome_trace(tracer)
    spans = [r for r in host["traceEvents"] if r.get("ph") == "X" and r["name"].startswith("dispatch/")]
    combined = tobs.correlate_device_trace(host, device)
    corr = combined["otherData"]["correlation"]
    assert corr["host_dispatches"] == len(spans) == 6
    assert corr["matched"] == corr["host_dispatches"]
    assert tobs.validate_chrome_trace(combined) == []
    annotated = [r for r in combined["traceEvents"] if r.get("args", {}).get("annotation")]
    assert all(r["args"]["annotation"] == tobs.dispatch_annotation(r["args"]["owner"], r["args"]["kind"])
               for r in annotated)


def test_the_bridge_opens_only_under_a_profiler(monkeypatch):
    """Without a profiler recording, a traced dispatch opens no
    ``record_function`` (it would cost two dispatcher calls for nothing)."""
    from metrics_tpu_torch.core import engine

    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(engine.torch.profiler, "record_function", lambda name: opened.append(name) or real(name))
    with tobs.trace():
        _accuracy_run(_Torch, [])
    assert opened == []
    from torch.profiler import ProfilerActivity, profile

    with tobs.trace(), profile(activities=[ProfilerActivity.CPU]):
        _accuracy_run(_Torch, [])
    assert opened.count(tobs.dispatch_annotation("Accuracy", "update")) == 3  # probe + 2 replays


def test_profiling_helpers(tmp_path):
    from metrics_tpu_torch.utils import profiling

    m = mt.Accuracy(device="cpu")
    profiling.trace_metric(m, "update")
    logits, target = _batches(5, steps=1)[0]
    with profiling.annotate("metrics/test"):
        m.update(torch.from_numpy(logits), torch.from_numpy(target))
    timing = profiling.time_update(m, torch.from_numpy(logits), torch.from_numpy(target), steps=3, warmup=1)
    assert set(timing) == {"eager_us", "compiled_us", "compile_s", "speedup"}
    assert m._update_count == 0 and m._compiled_update is None
    assert profiling.dispatch_annotation is tobs.dispatch_annotation
    profiling.start_trace(str(tmp_path))
    with pytest.raises(RuntimeError):
        profiling.start_trace(str(tmp_path))
    m.update(torch.from_numpy(logits), torch.from_numpy(target))
    profiling.stop_trace()
    assert list(tmp_path.iterdir())
    with pytest.raises(RuntimeError):
        profiling.stop_trace()


# --------------------------------------------------------------------------- #
# the regression watchdog
# --------------------------------------------------------------------------- #
def _rounds(tmp_path):
    values = [100.0, 104.0, 98.0, 101.0, 180.0]
    paths = []
    for i, v in enumerate(values, start=1):
        record = {"metric": "step_us_per_step", "value": v, "unit": "us",
                  "extra": {"a": {"fused_us": v / 2, "speedup": 4.0 - i * 0.1, "overhead_pct": 1.0 + i,
                                  "calls": i}}}
        path = tmp_path / f"BENCH_r{i:02d}.json"
        if i == 3:  # a run wrapper with log noise around the record
            path.write_text(json.dumps({"n": i, "cmd": "bench", "rc": 0,
                                        "tail": "warning: noise\n" + json.dumps(record) + "\ndone"}))
        else:
            path.write_text(json.dumps(record))
        paths.append(str(path))
    bad = tmp_path / "BENCH_r06.json"
    bad.write_text("{not json")
    return paths + [str(bad)]


@pytest.mark.parametrize("all_rounds", [False, True])
def test_regress_reports_equal_the_jax_packages(tmp_path, all_rounds):
    paths = _rounds(tmp_path)
    got = tobs.check_paths(paths, all_rounds=all_rounds).to_dict()
    want = jobs.check_paths(paths, all_rounds=all_rounds).to_dict()
    assert got == want
    assert not got["ok"] and got["regressions"]


def test_regress_cli_equals_the_jax_packages(tmp_path, capsys):
    from metrics_tpu.observability.__main__ import main as jax_main
    from metrics_tpu_torch.observability.__main__ import main as torch_main

    paths = _rounds(tmp_path)
    outputs = []
    for main in (torch_main, jax_main):
        rc = main(["regress", "--json", *paths])
        outputs.append((rc, json.loads(capsys.readouterr().out)))
    assert outputs[0] == outputs[1] and outputs[0][0] == 1
    assert torch_main(["regress", *paths[:2]]) == 0

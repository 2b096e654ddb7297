"""The port's serving front-end (``metrics_tpu_torch.serve``) against the
JAX package's, and the engine's rules for several threads on one device.

The same seeded numpy observations go over loopback HTTP to a JAX
``IngestServer`` and to the port's (on ``device="cpu"``), both over a
TenantSet of Accuracy (micro), F1 (macro) and BinnedAveragePrecision (10
classes, 21 thresholds):

- served reads against the JAX package's ``offline_replay`` of the same log
  (the integer states bitwise, float results within the A1 harness's 1e-6)
  and bitwise against the port's own replay;
- status codes, ``Retry-After``, reasons and JSON keys of every endpoint
  and rejection equal (200, 400, 404, 429 ``tenant_cap`` / ``queue_full``
  / ``tenant_capacity`` / ``tenant_fenced``, 503 ``deadline_missed`` /
  ``draining``), with the dispatchers not started, so that no queue state
  depends on timing;
- the ``serve/*`` events, the ``metrics_tpu_ingest_*`` Prometheus names and
  the chaos ``FaultEvent`` sites equal under the same traffic and plan;
- the port's captured steps are those of the bucket widths its dispatcher
  met, counted from what it dispatched (the JAX test of that property
  compares against the compiles of an earlier point instead, which depends on
  which widths the coalescer built under load);
- the engine's thread repairs: another thread's ``tolist`` while one engine
  probes, a capture's launch record, the collector's counted hold, the
  capture's error mode and the side stream per thread; and the TenantSet's
  export (host copies) and import (a decoded snapshot's sorted states).

One JAX server pair per module: every JAX bucket width compiles.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as M
import metrics_tpu_torch as mt
from metrics_tpu import observability as jobs
from metrics_tpu import serve as jsv
from metrics_tpu.observability.instruments import REGISTRY as JREGISTRY
from metrics_tpu.resilience import chaos as jchaos
from metrics_tpu_torch import observability as obs
from metrics_tpu_torch import serve as msv
from metrics_tpu_torch.core import engine
from metrics_tpu_torch.observability.instruments import REGISTRY
from metrics_tpu_torch.ops import kernels as kernels_mod
from metrics_tpu_torch.resilience import chaos
from metrics_tpu_torch.utils.exceptions import Uncapturable
from tests.helpers.torch_parity import ATOL, RTOL
from tests.helpers.torch_port import one_torch_thread  # noqa: F401  (the module fixture)

pytestmark = [pytest.mark.network, pytest.mark.usefixtures("one_torch_thread"), pytest.mark.filterwarnings("ignore")]

CLASSES, THRESHOLDS, ROWS = 10, 21, 16
CPU = dict(device="cpu")


def _template(pkg, **kw):
    return pkg.MetricCollection({
        "acc": pkg.Accuracy(num_classes=CLASSES, average="micro", **kw),
        "f1": pkg.F1Score(num_classes=CLASSES, average="macro", **kw),
        "ap": pkg.BinnedAveragePrecision(num_classes=CLASSES, thresholds=THRESHOLDS, **kw),
    })


def _port_template():
    return _template(mt, **CPU)


def _rows(rng, n):
    raw = rng.random((n, ROWS, CLASSES), dtype=np.float32) + np.float32(1e-3)
    return (raw / raw.sum(-1, keepdims=True)).astype(np.float32), rng.integers(0, CLASSES, (n, ROWS), dtype=np.int32)


def _http(url, body=None, ctype="application/x-npz"):
    """``(status, headers, JSON document)`` of one request; errors are results."""
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype} if body is not None else {},
                                 method="POST" if body is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read().decode())
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), json.loads(err.read().decode())


def _shape(doc):
    """A JSON document's nested key structure, without its values."""
    if isinstance(doc, dict):
        return {k: _shape(v) for k, v in doc.items() if k not in ("per_tenant", "last_applied_step")}
    return type(doc).__name__


# --------------------------------------------------------------------------- #
# one JAX and one port server fed the same log
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def served():
    """Both packages' servers, fed the same observations with their
    dispatchers stopped, then started: each pops the same three 6-wide
    batches (bucket 8) and the batched tenant's steps, so both build the same
    widths. Traced in both packages."""
    rng = np.random.default_rng(190)
    tenants = [f"t{i}" for i in range(6)]
    probs, labels = _rows(rng, 3 * len(tenants) + 4)
    servers = {"jax": jsv.IngestServer(_template(M), queue_capacity=64, name="serve-parity"),
               "port": msv.IngestServer(_port_template(), queue_capacity=64, name="serve-parity")}
    log, docs = [], {"jax": [], "port": []}
    with jobs.trace() as jtracer, obs.trace() as ttracer:
        for s in servers.values():
            s._life.start()
        k = 0
        for _ in range(3):
            for tid in tenants:
                for name, s in servers.items():
                    docs[name].append(jsv.IngestClient(s.url).post(tid, probs[k], labels[k]))
                log.append((tid, (probs[k], labels[k]), {}))
                k += 1
        for name, s in servers.items():
            docs[name].append(jsv.IngestClient(s.url).post_steps("batched", probs[k:k + 4], labels[k:k + 4]))
        log += [("batched", (probs[k + i], labels[k + i]), {}) for i in range(4)]
        for s in servers.values():
            s.pipeline.start()
            assert s.drain(60.0)
        reads = {name: {tid: msv.IngestClient(s.url).read(tid, max_staleness_steps=0, timeout_s=30)
                        for tid in tenants + ["batched"]} for name, s in servers.items()}
    yield dict(servers=servers, log=log, docs=docs, reads=reads, tenants=tenants + ["batched"],
               events={"jax": jtracer.events(), "port": ttracer.events()})
    for s in servers.values():
        s.stop(drain=False, timeout=5.0)


def test_served_reads_equal_the_jax_packages_replay(served):
    jax_oracle = jsv.offline_replay(lambda: _template(M), served["log"])
    port_oracle = msv.offline_replay(_port_template, served["log"])
    for tid in served["tenants"]:
        got = served["reads"]["port"][tid]
        assert got["status"] == 200 and got["staleness_steps"] == 0
        for name, want in jax_oracle[tid].items():
            value = np.asarray(got["values"][name], dtype=np.float32)
            np.testing.assert_allclose(value, want, rtol=RTOL, atol=ATOL, err_msg=f"{tid} {name}")
            np.testing.assert_array_equal(value, port_oracle[tid][name], err_msg=f"{tid} {name}")
            np.testing.assert_allclose(value, np.asarray(served["reads"]["jax"][tid]["values"][name], np.float32),
                                       rtol=RTOL, atol=ATOL)


def test_stacked_integer_states_equal_the_jax_servers_bitwise(served):
    got = served["servers"]["port"].tenant_set
    want = served["servers"]["jax"].tenant_set
    for tid in served["tenants"]:
        a, b = got.export_tenant(tid), want.export_tenant(tid)
        assert a["update_count"] == b["update_count"] and a["aux"] == b["aux"]
        for leader, states in b["states"].items():
            for name, value in states.items():
                value = np.asarray(value)
                mine = a["states"][leader][name].numpy()
                assert mine.dtype == value.dtype, (leader, name)
                np.testing.assert_array_equal(mine, value, err_msg=f"{tid} {leader}.{name}")


def test_admission_echoes_equal(served):
    for jdoc, tdoc in zip(served["docs"]["jax"], served["docs"]["port"]):
        assert jdoc == tdoc


def test_both_servers_built_the_same_widths(served):
    j, t = (served["servers"][n].stats() for n in ("jax", "port"))
    for section in ("tenant_set", "dispatcher", "ledger"):
        assert _shape(j[section]) == _shape(t[section]), section
    for key in ("compiles", "dispatches", "last_bucket", "partition_builds", "active"):
        assert t["tenant_set"][key] == j["tenant_set"][key], key
    assert t["ledger"]["admitted"] == t["ledger"]["applied"] == len(served["log"])
    assert _shape(j) == _shape(t)


def test_serve_events_equal_the_jax_packages(served):
    def names(events):
        return sorted({e.name for e in events if e.name.startswith("serve/")})

    assert names(served["events"]["port"]) == names(served["events"]["jax"])
    assert {"serve/ingest", "serve/coalesce", "serve/dispatch", "serve/read", "serve/drain"} <= set(
        names(served["events"]["port"]))
    count = lambda evs, n: sum(e.name == n for e in evs)  # noqa: E731
    for name in ("serve/ingest", "serve/dispatch", "serve/read"):
        assert count(served["events"]["port"], name) == count(served["events"]["jax"], name), name


def test_ingest_prometheus_names_equal_the_jax_packages(served):
    def names(text):
        # this module's pipelines only: the registry is the process's, and
        # other modules' pipelines may have rejected what these did not
        return sorted({line.split("{")[0] for line in text.splitlines()
                       if line.startswith("metrics_tpu_ingest_") and 'queue="serve-parity"' in line})

    got = names(obs.to_prometheus_text(REGISTRY))
    want = names(jobs.to_prometheus_text(JREGISTRY))
    assert got == want and "metrics_tpu_ingest_admitted_total" in got


def test_chaos_fault_sites_equal_under_the_same_plan(served):
    """The same plan over the same calls: an ingress fault (503), a transient
    dispatch fault (retried) and a read fault (503), in both packages."""
    specs = [("serve/ingest", 2), ("serve/dispatch", 1), ("serve/read", 1)]
    rng = np.random.default_rng(191)
    probs, labels = _rows(rng, 2)
    results = {}
    for name, (mod, srv) in {"jax": (jchaos, served["servers"]["jax"]),
                             "port": (chaos, served["servers"]["port"])}.items():
        client = jsv.IngestClient(srv.url)
        plan = [mod.FaultSpec(site=site, kind="error", nth=nth, times=1) for site, nth in specs]
        with mod.plan(plan, seed=3) as armed:
            docs = [client.post("t0", probs[0], labels[0]), client.post("t0", probs[1], labels[1])]
            assert srv.drain(30.0)
            docs.append(client.read("t0", max_staleness_steps=0))
            docs.append(client.read("t0", max_staleness_steps=0))
        # the dispatch may pop the first post before or after the second
        # arrives: the sites are compared as a multiset
        results[name] = (sorted((e.site, e.kind) for e in armed.log),
                         [(d["status"], d.get("reason"), d.get("admitted")) for d in docs])
    assert results["port"] == results["jax"]
    assert [s for s, _ in results["port"][0]] == ["serve/dispatch", "serve/ingest", "serve/read"]
    assert results["port"][1] == [(200, None, True), (503, "fault", False), (503, "fault", None), (200, None, None)]
    served["log"].append(("t0", (probs[0], labels[0]), {}))
    for name, srv in served["servers"].items():
        assert srv.stats()["dispatcher"]["retries"] == 1, name


# --------------------------------------------------------------------------- #
# status codes, headers and keys with the dispatchers stopped
# --------------------------------------------------------------------------- #
def _admission_script(server, probs, labels):
    """One fixed sequence of requests against a stalled server (HTTP up, the
    dispatcher not started): ``(status, Retry-After, reason, keys)`` each."""
    url, p, y = server.url, probs, labels
    body = lambda i: jsv.encode_npz(p[i], y[i])  # noqa: E731
    out = []

    def record(status, headers, doc):
        out.append((status, headers.get("Retry-After"), doc.get("reason") or doc.get("error", "")[:20],
                    sorted(doc)))

    for i in range(3):  # t0 twice admitted, then its fairness cap
        record(*_http(f"{url}/ingest/t0", body(i)))
    for i, tid in enumerate(("t1", "t2", "t3")):  # fill the tenant set (capacity 4)
        record(*_http(f"{url}/ingest/{tid}", body(i)))
    record(*_http(f"{url}/ingest/t4", body(0)))  # tenant_capacity
    for tid in ("t1", "t2", "t3"):  # the queue to its capacity of 8
        record(*_http(f"{url}/ingest/{tid}", body(1)))
    record(*_http(f"{url}/ingest/t1", body(2)))  # queue_full
    server.pipeline.fence_tenant("t2", retry_after_s=3.0)
    record(*_http(f"{url}/ingest/t2", body(2)))  # tenant_fenced
    record(*_http(f"{url}/read/t0?max_staleness_steps=0&timeout_s=0.05"))  # deadline_missed
    record(*_http(f"{url}/read/ghost"))
    record(*_http(f"{url}/nowhere"))
    record(*_http(f"{url}/ingest/t0", b"not an npz"))
    record(*_http(f"{url}/ingest/", body(0)))
    bad = io.BytesIO()
    np.savez(bad, __steps__=np.asarray(3), arg0=p[:2], arg1=y[:2])
    record(*_http(f"{url}/ingest/t0", bad.getvalue()))  # a lying step count
    status, _, doc = _http(f"{url}/healthz")
    out.append((status, sorted(doc)))
    status, _, doc = _http(f"{url}/stats.json")
    out.append((status, _shape(doc)))
    server.pipeline.queue.close()
    record(*_http(f"{url}/ingest/t1", body(0)))  # draining
    return out


def test_status_codes_headers_and_keys_equal_the_jax_packages():
    rng = np.random.default_rng(192)
    probs, labels = _rows(rng, 3)
    scripts = {}
    for name, pkg, sv, kw in (("jax", M, jsv, {}), ("port", mt, msv, CPU)):
        server = sv.IngestServer(pkg.TenantSet(_template(pkg, **kw), capacity=4), queue_capacity=8, retry_after_s=2.0)
        server._life.start()
        try:
            scripts[name] = _admission_script(server, probs, labels)
        finally:
            server.stop(drain=False, timeout=1.0)
    assert scripts["port"] == scripts["jax"]
    codes = [entry[0] for entry in scripts["port"]]
    assert codes == [200, 200, 429, 200, 200, 200, 429, 200, 200, 200, 429, 429, 503, 404, 404, 400, 400, 400,
                     200, 200, 503]
    reasons = [entry[2] for entry in scripts["port"] if entry[0] in (429, 503)]
    assert reasons == ["tenant_cap", "tenant_capacity", "queue_full", "tenant_fenced", "deadline_missed",
                       "draining"]
    assert scripts["port"][11][1] == "3"  # the fence's own Retry-After


# --------------------------------------------------------------------------- #
# the port alone: widths, bodies, lifecycle
# --------------------------------------------------------------------------- #
def _recording(ts):
    widths, apply = [], ts.apply_batch

    def record(ids, *args, **kwargs):
        widths.append(len(ids))
        return apply(ids, *args, **kwargs)

    ts.apply_batch = record
    return widths


def test_ragged_ingest_builds_one_step_per_width_it_met():
    """Ragged arrivals while the dispatcher runs: whatever widths the
    coalescer built, the set holds one captured step for each, and the reads
    equal the replay bitwise."""
    ts = mt.TenantSet(_port_template(), capacity=32)
    widths = _recording(ts)
    server = msv.IngestServer(ts).start()
    try:
        client = msv.IngestClient(server.url)
        rng = np.random.default_rng(193)
        tenants = [f"tenant-{i}" for i in range(7)]
        log = []
        for _ in range(4):
            pick = sorted(rng.choice(len(tenants), size=int(rng.integers(1, len(tenants) + 1)), replace=False))
            probs, labels = _rows(rng, len(pick))
            for j, t in enumerate(pick):
                assert client.post(tenants[t], probs[j], labels[j])["admitted"]
                log.append((tenants[t], (probs[j], labels[j]), {}))
        assert server.drain(30.0)
        want = msv.offline_replay(_port_template, log)
        for tid, ref in want.items():
            doc = client.read(tid, max_staleness_steps=0, timeout_s=10)
            for name, value in ref.items():
                np.testing.assert_array_equal(np.asarray(doc["values"][name], dtype=value.dtype), value)
        stats = server.stats()
        built = sorted(k[1] for k in ts._steps if k[0] == "update")
        assert built == sorted({kernels_mod.next_pow2(k) for k in widths})
        assert stats["tenant_set"]["compiles"] == len(built) + 1  # and the reads' width 1
        assert stats["tenant_set"]["partition_builds"] == 1
        assert stats["ledger"]["admitted"] == stats["ledger"]["applied"] == len(log)
        assert stats["dispatcher"]["dispatches"] == len(widths) and sum(widths) == len(log)
    finally:
        server.stop(drain=False)


def test_read_values_come_to_the_host_element_by_element():
    ap = [torch.tensor(0.5), torch.tensor(float("nan"))]
    assert msv.server.host_value(ap).tolist()[0] == 0.5
    assert msv.server.host_value(torch.tensor([1, 2], dtype=torch.int32)).dtype == np.int32
    assert np.asarray(jnp.asarray(np.float32(0.25))).tolist() == msv.server.host_value(torch.tensor(0.25)).tolist()


def test_body_codecs_decode_across_the_packages():
    rng = np.random.default_rng(194)
    probs, labels = _rows(rng, 3)
    for encode in (msv.encode_npz, jsv.encode_npz):
        for decode in (msv.decode_body, jsv.decode_body):
            args, kwargs = decode("application/x-npz", encode(probs[0], labels[0], sample_weight=labels[1]))
            np.testing.assert_array_equal(args[0], probs[0])
            np.testing.assert_array_equal(kwargs["sample_weight"], labels[1])
    for encode in (msv.encode_npz_steps, jsv.encode_npz_steps):
        for decode in (msv.decode_steps, jsv.decode_steps):
            steps, batched = decode("application/x-npz", encode(probs, labels))
            assert batched and len(steps) == 3
            np.testing.assert_array_equal(steps[2][0][0], probs[2])
    doc = json.dumps({"args": [{"data": [1.5, 2.5], "dtype": "float32"}, [1, 2]], "kwargs": {"k": 3}}).encode()
    got, want = msv.decode_body("application/json", doc), jsv.decode_body("application/json", doc)
    assert got[1] == want[1] and all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(got[0], want[0]))
    with pytest.raises(ValueError, match="leading step axis"):
        msv.encode_npz_steps(probs, labels[:2])
    with pytest.raises(ValueError, match="unsupported Content-Type"):
        msv.decode_body("text/plain", b"")


def test_singleton_lifecycle_and_local_fallback():
    pipeline = msv.serve(_port_template(), port=0)
    try:
        assert msv.get_server() is pipeline and msv.serve() is pipeline and pipeline.kind == "http"
        assert pipeline.host == "127.0.0.1"
        taken = pipeline.port
        local = msv.server.serve
        msv.shutdown()
        assert msv.get_server() is None
        fallback = local(_port_template(), port=taken, fallback_local=True)  # the port is free again: binds
        msv.shutdown()
        with pytest.raises(mt.utils.exceptions.MetricsUserError, match="needs a TenantSet"):
            msv.serve()
        assert fallback.kind == "http"
    finally:
        msv.shutdown(drain=False)


def test_pipeline_registers_with_the_instrument_registry():
    pipeline = msv.IngestPipeline(_port_template(), name="registered")
    assert pipeline in REGISTRY.live_ingest_pipelines()
    text = obs.to_prometheus_text(REGISTRY)
    assert 'metrics_tpu_ingest_queue_capacity{queue="registered"} 256' in text


def test_dead_letters_are_surfaced_not_dropped():
    pipeline = msv.IngestPipeline(_port_template(), name="dead").start()
    try:
        rng = np.random.default_rng(195)
        probs, labels = _rows(rng, 1)
        with chaos.plan([chaos.FaultSpec("serve/dispatch", kind="error", transient=False)], seed=0):
            assert pipeline.post("a", probs[0], labels[0]).admitted
            assert pipeline.drain(10.0)
        doc = pipeline.read("a", max_staleness_steps=0)
        assert doc["dead_lettered_steps"] == 1 and doc["staleness_steps"] == 0
        assert pipeline.dispatcher.dead_letters[0].tenant_ids == ["a"]
        assert pipeline.stats()["dispatcher"]["error"].startswith("ChaosError")
    finally:
        pipeline.stop(drain=False)


# --------------------------------------------------------------------------- #
# the engine with several threads
# --------------------------------------------------------------------------- #
class _Blocking(mt.Metric):
    """A sum whose update, at the probe, waits for the test's go-ahead."""

    full_state_update = True

    def __init__(self, entered, release):
        super().__init__(**CPU)
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")
        self.entered, self.release, self.calls = entered, release, 0

    def update(self, x):
        self.calls += 1
        if self.calls == 2:  # the engine's probe of the second call
            self.entered.set()
            assert self.release.wait(30)
        self.total = self.total + x.sum()

    def compute(self):
        return self.total


def test_another_threads_tolist_works_while_one_engine_probes():
    entered, release = threading.Event(), threading.Event()
    metric = _Blocking(entered, release)
    errors = []

    def drive():
        try:
            for _ in range(3):
                metric.update(torch.ones(4))
        except BaseException as err:  # noqa: BLE001 — reported below
            errors.append(err)

    worker = threading.Thread(target=drive)
    worker.start()
    try:
        assert entered.wait(30)
        # the probe refuses host reads in its own thread, and only there
        assert torch.tensor([1.0, 2.0]).tolist() == [1.0, 2.0]
        assert torch.tensor([3, 4]).numpy().tolist() == [3, 4]
    finally:
        release.set()
        worker.join(30)
    assert not errors, errors
    assert metric._update_engine.broken is None and metric._update_engine.stats.cache_misses == 1
    assert float(metric.compute()) == 12.0
    with engine._probe(), pytest.raises(Uncapturable, match="tolist"):
        torch.ones(2).tolist()
    assert "tolist" not in torch.Tensor.__dict__ or torch.Tensor.__dict__["tolist"] is not None


class _FakeGraph:
    def replay(self):
        pass


def test_a_capture_records_only_its_own_threads_launches(monkeypatch):
    kernel = kernels_mod.CUDA_KERNELS["binned_counts"]
    inside, done, block = threading.Event(), threading.Event(), threading.Event()

    def step(state, args, kwargs):
        kernels_mod.count_launch(kernel)  # what a wrapper does where it launches
        if block.is_set():  # the capture's run of the body waits for the other thread
            inside.set()
            assert done.wait(30)
        return {"x": state["x"] + args[0]}

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, pool=None, stream=None, capture_error_mode=None: contextlib.nullcontext())
    kernels_mod.reset_launch_counts()
    captured = engine.CapturedStep(step, writes_state=True)
    captured.probe({"x": torch.zeros(3)}, (torch.ones(3),), {})  # the CPU's probe: statics only
    kernels_mod.reset_launch_counts()
    block.set()
    worker = threading.Thread(target=captured._capture, args=(None,))
    worker.start()
    assert inside.wait(30)
    for _ in range(5):  # another thread launches while the capture runs
        kernels_mod.count_launch(kernel)
    done.set()
    worker.join(30)
    assert captured.launch_delta == {"binned_counts": 1}
    assert kernels_mod.launch_counts()["binned_counts"] == 5
    captured.replay()
    assert kernels_mod.launch_counts()["binned_counts"] == 6
    kernels_mod.reset_launch_counts()


def test_captures_run_in_their_threads_error_mode(monkeypatch):
    seen = []

    def graph(graph, pool=None, stream=None, capture_error_mode="global"):
        seen.append(capture_error_mode)
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    captured = engine.CapturedStep(lambda state, args, kwargs: {"x": state["x"] + 1}, writes_state=True)
    captured.probe({"x": torch.zeros(3)}, (), {})
    captured._capture(side=None)
    assert seen == ["thread_local"]


def test_the_collector_stays_off_until_the_last_capture_ends():
    enabled = gc.isenabled()
    gc.enable()
    try:
        first_in, second_in, first_out = threading.Event(), threading.Event(), threading.Event()
        seen = []

        def first():
            with engine._collector_held():
                first_in.set()
                assert second_in.wait(30)
            first_out.set()

        def second():
            assert first_in.wait(30)
            with engine._collector_held():
                second_in.set()
                assert first_out.wait(30)
                seen.append(gc.isenabled())  # the first hold ended; this one still runs
            seen.append(gc.isenabled())

        threads = [threading.Thread(target=f) for f in (first, second)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
        assert seen == [False, True]
    finally:
        (gc.enable if enabled else gc.disable)()


def test_each_thread_probes_and_captures_on_its_own_stream(monkeypatch):
    made = []

    class Stream:
        def __init__(self, device=None):
            made.append(self)

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    device = torch.device("cuda", 0)
    out = {}

    def take(name):
        out[name] = (engine._capture_stream(device), engine._capture_stream(device))

    threads = [threading.Thread(target=take, args=(n,)) for n in ("a", "b")]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
    assert out["a"][0] is out["a"][1] and out["b"][0] is out["b"][1]
    assert out["a"][0] is not out["b"][0] and len(made) == 2


# --------------------------------------------------------------------------- #
# TenantSet export and import
# --------------------------------------------------------------------------- #
def test_export_returns_host_copies_of_eager_states():
    rng = np.random.default_rng(196)
    probs, _ = _rows(rng, 1)
    ts = mt.TenantSet(mt.MetricCollection({"cat": mt.CatMetric(**CPU)}), capacity=4)
    assert ts.partition_view()["tenant"]["cat"]["path"] == engine.PATH_EAGER
    ts.apply_batch(["a"], probs[:, :, 0], auto_admit=True)
    snap = ts.export_tenant("a")
    (leaf,) = snap["eager_states"]["cat"]["value"]
    assert leaf.device.type == "cpu"
    leaf.fill_(-1.0)  # the export is a copy: the set keeps its value
    assert ts.compute(["a"])["a"]["cat"].tolist() == probs[0, :, 0].tolist()


def test_import_of_a_decoded_snapshot_keeps_each_state():
    from metrics_tpu_torch.cluster import decode_tenant_snapshot, encode_tenant_snapshot

    rng = np.random.default_rng(197)
    probs, labels = _rows(rng, 2)
    src = mt.TenantSet(_port_template(), capacity=4)
    src.apply_batch(["a", "b"], probs, labels, auto_admit=True)
    dst = mt.TenantSet(_port_template(), capacity=4)
    snap = decode_tenant_snapshot(encode_tenant_snapshot(src.export_tenant("a")))
    assert list(snap["states"]["acc"]) == sorted(snap["states"]["acc"])  # the wire sorts them
    dst.import_tenant("a", snap)
    want, got = src.export_tenant("a"), dst.export_tenant("a")
    for leader, states in want["states"].items():
        for name, value in states.items():
            assert torch.equal(got["states"][leader][name], value), (leader, name)

"""The port's cluster tier (``metrics_tpu_torch.cluster``) against the JAX
package's.

- ``rendezvous_owner``, ``ShardMap`` and ``plan_rebalance`` give the JAX
  package's owners, maps and moves (1,000 tenants over 2–5 replicas);
- ``encode_tenant_snapshot`` is byte for byte the JAX package's for the same
  tenant state: config2 with BinnedAveragePrecision, a ``Quantile`` sketch
  member, a ``CatBuffer`` member and an unbounded list member, and every
  wire leaf kind built by hand; a JAX blob decodes in the port and imports;
- one scenario run in both packages on in-process clusters (posts, a
  migration aborted by a fault at ``cluster/export`` and retried, a replica
  lost and recovered from its checkpoint): the ``cluster/*`` events, the
  ``FaultEvent`` sites, the migration records, the status documents and the
  ``metrics_tpu_cluster_*`` Prometheus names equal, every read bitwise its
  replay in the port and within 1e-6 of the JAX package's;
- over HTTP: the 307 with ``X-Metrics-Shard-Epoch`` and ``Location``, the
  coordinator's endpoints, equal in both packages;
- the port alone: migration under posts, the chaos sweep of every phase,
  a source that dies mid-move, the streamed frames' verification, and the
  CLI with ``--device cpu``.

JAX TenantSets compile each bucket width: the scenario runs once a module.
"""
from __future__ import annotations

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
from metrics_tpu import cluster as jcl
from metrics_tpu import observability as jobs
from metrics_tpu import serve as jsv
from metrics_tpu.cluster import __main__ as jcli
from metrics_tpu.resilience import chaos as jchaos
from metrics_tpu_torch import cluster as tcl
from metrics_tpu_torch import observability as obs
from metrics_tpu_torch import serve as msv
from metrics_tpu_torch.cluster import __main__ as tcli
from metrics_tpu_torch.core.buffers import CatBuffer
from metrics_tpu_torch.resilience import chaos
from metrics_tpu_torch.serve.server import SHARD_EPOCH_HEADER
from tests.helpers.torch_parity import ATOL, RTOL
from tests.helpers.torch_port import one_torch_thread  # noqa: F401  (the module fixture)

pytestmark = [pytest.mark.cluster, pytest.mark.usefixtures("one_torch_thread"), pytest.mark.filterwarnings("ignore")]

CPU = dict(device="cpu")


def _small(pkg, **kw):
    """tests/cluster/conftest.py's collection."""
    return pkg.MetricCollection({"acc": pkg.Accuracy(num_classes=4, average="micro", **kw),
                                 "mse": pkg.MeanSquaredError(**kw)})


def _port_small():
    return _small(mt, **CPU)


def _batch(rng):
    return rng.integers(0, 4, size=(8,)).astype(np.int32), rng.integers(0, 4, size=(8,)).astype(np.int32)


def _prom_names(text, prefix, label):
    """The series names under ``prefix`` that carry ``label``: the registry
    is the process's, so other modules' clusters may have series there too."""
    return sorted({line.split("{")[0] for line in text.splitlines() if line.startswith(prefix) and label in line})


# --------------------------------------------------------------------------- #
# shard map and planner
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_owners_and_rebalance_plans_equal_the_jax_packages(n):
    replicas = tuple(f"r{i}" for i in range(n))
    tenants = [f"tenant-{i}" for i in range(1000)] + list(range(50))
    assert [tcl.rendezvous_owner(t, replicas) for t in tenants] == [jcl.rendezvous_owner(t, replicas) for t in tenants]
    tmap, jmap = tcl.ShardMap(replicas), jcl.ShardMap(replicas)
    assert tmap.assignment(tenants) == jmap.assignment(tenants)
    tmap, jmap = tmap.with_pin("tenant-7", replicas[-1]), jmap.with_pin("tenant-7", replicas[-1])
    assert tmap.to_json() == jmap.to_json() and tcl.ShardMap.from_json(jmap.to_json()) == tmap
    rng = np.random.default_rng(200 + n)
    weights = {t: float(w) for t, w in zip(map(str, tenants), rng.pareto(1.5, len(tenants)) + 1.0)}
    occupancy = {r: {} for r in replicas}
    for t, w in weights.items():
        occupancy[tmap.owner(t) if tmap.owner(t) != replicas[0] or n == 2 else replicas[1]][t] = w
    for tol in (0.05, 0.10, 0.5):
        got = tcl.plan_rebalance(tmap, occupancy, tolerance=tol, max_moves=200)
        want = jcl.plan_rebalance(jmap, occupancy, tolerance=tol, max_moves=200)
        assert [m.to_dict() for m in got] == [m.to_dict() for m in want]


def test_shard_map_refusals_equal():
    for make in (lambda pkg: pkg.ShardMap(()), lambda pkg: pkg.ShardMap(("a", "a")),
                 lambda pkg: pkg.ShardMap(("a",), pins={"t": "b"}),
                 lambda pkg: pkg.ShardMap(("a", "b")).with_pin("t", "c"),
                 lambda pkg: pkg.ShardMap(("a", "b")).with_pin("t", "b").with_replicas(("a",)),
                 lambda pkg: pkg.ShardMap.from_dict({"version": 2, "replicas": ["a"]})):
        errors = []
        for pkg in (tcl, jcl):
            with pytest.raises(ValueError) as info:
                make(pkg)
            errors.append(str(info.value))
        assert errors[0] == errors[1]


# --------------------------------------------------------------------------- #
# the wire codec
# --------------------------------------------------------------------------- #
def _config2(pkg, **kw):
    return pkg.MetricCollection({
        "acc": pkg.Accuracy(num_classes=10, average="micro", **kw),
        "f1": pkg.F1Score(num_classes=10, average="macro", **kw),
        "precision": pkg.Precision(num_classes=10, average="macro", **kw),
        "recall": pkg.Recall(num_classes=10, average="macro", **kw),
        "binned_ap": pkg.BinnedAveragePrecision(num_classes=10, thresholds=21, **kw),
    })


def _probs(rng, shape):
    raw = rng.random((*shape, 10), dtype=np.float32) + np.float32(1e-3)
    return (raw / raw.sum(-1, keepdims=True)).astype(np.float32)


TEMPLATES = {
    "config2_binned_ap": (_config2, lambda rng: (_probs(rng, (3, 16)), rng.integers(0, 10, (3, 16), dtype=np.int32))),
    "quantile_sketch": (lambda pkg, **kw: pkg.MetricCollection({"q": pkg.Quantile(q=0.5, **kw)}),
                        lambda rng: (rng.lognormal(size=(3, 32)).astype(np.float32),)),
    "catbuffer": (lambda pkg, **kw: pkg.MetricCollection({"cat": pkg.CatMetric(buffer_capacity=64, **kw)}),
                  lambda rng: (rng.normal(size=(3, 8)).astype(np.float32),)),
    "list_state": (lambda pkg, **kw: pkg.MetricCollection({"cat": pkg.CatMetric(**kw), "q": pkg.Quantile(q=0.9, **kw)}),
                   lambda rng: (rng.lognormal(size=(3, 8)).astype(np.float32),)),
}


@pytest.mark.parametrize("case", sorted(TEMPLATES))
def test_tenant_snapshots_encode_to_the_jax_packages_bytes(case):
    make, rows = TEMPLATES[case]
    rng = np.random.default_rng(210)
    jts, tts = M.TenantSet(make(M), capacity=4), mt.TenantSet(make(mt, **CPU), capacity=4)
    ids = ["a", "b", "c"]
    for _ in range(3):
        args = rows(rng)
        jts.apply_batch(ids, *(jnp.asarray(a) for a in args), auto_admit=True)
        tts.apply_batch(ids, *args, auto_admit=True)
    for tid in ids:
        blob = tcl.encode_tenant_snapshot(tts.export_tenant(tid))
        assert blob == jcl.encode_tenant_snapshot(jts.export_tenant(tid)), tid
        # the JAX blob imports into a fresh port set and reads the same
        other = mt.TenantSet(make(mt, **CPU), capacity=2)
        other.import_tenant(tid, tcl.decode_tenant_snapshot(jcl.encode_tenant_snapshot(jts.export_tenant(tid))))
        assert tcl.encode_tenant_snapshot(other.export_tenant(tid)) == blob
        got, want = other.compute([tid])[tid], tts.compute([tid])[tid]
        for name in want:
            np.testing.assert_array_equal(msv.server.host_value(got[name]), msv.server.host_value(want[name]))


def _leaf_kinds(pkg, array, catbuffer, sketches):
    count_min, quantile = sketches
    return {
        "states": {"acc": {
            "correct": array(np.asarray(7, np.int32)), "total": array(np.asarray(9.5, np.float64)),
            "confmat": array(np.arange(16, dtype=np.uint8).reshape(4, 4)),
            "freqs": count_min.replace(counts=array(np.arange(128, dtype=np.float32).reshape(2, 64)),
                                       total=array(np.asarray(128.0, np.float32))),
        }},
        "eager_states": {"mse": {
            "vals": [array(np.zeros((3,), np.float16)), array(np.ones((3,), np.float16))],
            "buf": catbuffer(array(np.arange(8, dtype=np.float32)), 5, overflowed=True),
            "empty_buf": catbuffer(None, 0, capacity=12),
            "mode": "global",
            "quants": quantile,
        }},
        "update_count": 42,
        "aux": {"mse": {"num_outputs": 1}},
    }


def test_every_leaf_kind_encodes_to_the_jax_packages_bytes():
    from metrics_tpu.core.buffers import CatBuffer as JCatBuffer
    from metrics_tpu.sketches import CountMinSketch as JCountMin, QuantileSketch as JQuantile
    from metrics_tpu_torch.sketches import CountMinSketch, QuantileSketch

    want = _leaf_kinds(M, np.asarray, JCatBuffer, (JCountMin(width=64, depth=2), JQuantile()))
    got = _leaf_kinds(mt, torch.from_numpy, lambda d, n, **kw: CatBuffer(d, n, **{"device": "cpu", **kw}),
                      (CountMinSketch(width=64, depth=2, **CPU), QuantileSketch(**CPU)))
    blob = tcl.encode_tenant_snapshot(got)
    assert blob == jcl.encode_tenant_snapshot(want)
    back = tcl.decode_tenant_snapshot(jcl.encode_tenant_snapshot(want))
    assert tcl.encode_tenant_snapshot(back) == blob
    assert isinstance(back["eager_states"]["mse"]["buf"], CatBuffer) and back["eager_states"]["mse"]["buf"]._over
    assert back["states"]["acc"]["correct"].shape == () and back["states"]["acc"]["correct"].dtype == torch.int32
    assert tcl.plan_transfer(got).to_dict() == jcl.plan_transfer(want).to_dict()
    frames = list(tcl.iter_frames(got, chunk_bytes=256))
    assert [(f.seq, f.leaf, f.index, f.last, f.payload) for f in frames] == [
        (f.seq, f.leaf, f.index, f.last, f.payload) for f in jcl.iter_frames(want, chunk_bytes=256)]


def test_streamed_transfer_verifies_every_frame():
    rng = np.random.default_rng(211)
    ts = mt.TenantSet(_config2(mt, **CPU), capacity=4)
    ts.apply_batch(["a"], _probs(rng, (1, 16)), rng.integers(0, 10, (1, 16), dtype=np.int32), auto_admit=True)
    snap = ts.export_tenant("a")
    frames = list(tcl.iter_frames(snap, chunk_bytes=512))
    receiver = tcl.TenantTransfer()
    for f in frames:
        receiver.feed(f, f.digest)
    assert tcl.encode_tenant_snapshot(receiver.finish()) == tcl.encode_tenant_snapshot(snap)
    assert receiver.peak_bytes <= tcl.plan_transfer(snap).plan_peak_bytes + 1024
    bad = tcl.Frame(frames[3].seq, frames[3].leaf, frames[3].index, frames[3].last, b"x" + frames[3].payload[1:])
    for stream, match in ((frames[:3] + [bad], "digest"), (frames[:2] + frames[3:], "out of order"),
                          (frames[:-1], "truncated"), (frames[1:], "out of order")):
        receiver = tcl.TenantTransfer()
        with pytest.raises(tcl.TransferError, match=match):
            for f in stream:
                receiver.feed(f, frames[f.seq].digest)
            receiver.finish()
    with pytest.raises(tcl.TransferError, match="header"):
        tcl.decode_tenant_snapshot(b"PK\x05\x06" + b"\x00" * 18)


# --------------------------------------------------------------------------- #
# one scenario in both packages
# --------------------------------------------------------------------------- #
def _scenario(pkg, sv, cl, ob, ch, tmp, **kw):
    """Posts to four tenants, a migration aborted at cluster/export then
    committed, checkpoints, a replica lost and recovered."""
    rng = np.random.default_rng(220)
    with ob.trace() as tracer:
        coordinator = cl.ClusterCoordinator(
            {f"r{i}": sv.IngestPipeline(_small(pkg, **kw), name=f"scen-r{i}") for i in range(2)},
            checkpoint_root=str(tmp), name="scen").start()
        client = cl.ClusterClient(dict(coordinator.replicas), coordinator)
        tenants = [f"t{i}" for i in range(4)]
        log = []
        try:
            for _ in range(2):
                for tid in tenants:
                    preds, target = _batch(rng)
                    assert client.post_with_retry(tid, preds, target)["admitted"]
                    log.append((tid, (preds, target), {}))
            for replica in coordinator.replicas.values():
                assert replica.pipeline.drain(30.0)
            tenant = tenants[0]
            src = coordinator.owner(tenant)
            dst = next(r for r in coordinator.replicas if r != src)
            with ch.plan([ch.FaultSpec(site="cluster/export", kind="error", nth=1, times=1)], seed=0) as armed:
                aborted = coordinator.migrate(tenant, dst)
                committed = coordinator.migrate(tenant, dst)
            faults = [(e.site, e.kind) for e in armed.log]
            assert coordinator.checkpoint_all(step=1)
            lost = coordinator.owner(tenants[1])
            coordinator.mark_lost(lost)
            degraded = coordinator.status()
            coordinator.recover_replica(lost, sv.IngestPipeline(_small(pkg, **kw), name="scen-back"))
            client.add_target(lost, coordinator.replicas[lost])
            reads = {tid: client.read(tid, max_staleness_steps=0, timeout_s=30) for tid in tenants}
            status = coordinator.status()
        finally:
            coordinator.stop(drain=False, timeout=5.0)
    prom = ob.to_prometheus_text()
    return dict(log=log, events=tracer.events(), faults=faults, records=(aborted.to_dict(), committed.to_dict()),
                degraded=degraded, status=status, reads=reads, prom=prom)


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    return {
        "jax": _scenario(M, jsv, jcl, jobs, jchaos, tmp_path_factory.mktemp("jax")),
        "port": _scenario(mt, msv, tcl, obs, chaos, tmp_path_factory.mktemp("port"), **CPU),
    }


def test_cluster_events_equal_the_jax_packages(scenario):
    def names(events):
        counts = {}
        for e in events:
            if e.name.startswith("cluster/"):
                counts[e.name] = counts.get(e.name, 0) + 1
        return counts

    got, want = names(scenario["port"]["events"]), names(scenario["jax"]["events"])
    assert got == want
    assert {"cluster/fence", "cluster/drain", "cluster/export", "cluster/transfer", "cluster/import",
            "cluster/cutover", "cluster/abort", "cluster/replica_lost", "cluster/replica_restored"} <= set(got)


def test_fault_sites_and_migration_records_equal(scenario):
    port, jax_ = scenario["port"], scenario["jax"]
    assert port["faults"] == jax_["faults"] == [("cluster/export", "error")]
    for got, want in zip(port["records"], jax_["records"]):
        got, want = dict(got), dict(want)
        assert got.pop("downtime_s") >= 0 and want.pop("downtime_s") >= 0
        assert got == want
    assert port["records"][0]["outcome"] == "aborted" and port["records"][1]["outcome"] == "committed"


def _timeless(doc):
    if isinstance(doc, dict):
        return {k: _timeless(v) for k, v in doc.items() if k != "downtime_s"}
    return doc


def test_status_documents_equal(scenario):
    for key in ("degraded", "status"):
        got, want = scenario["port"][key], scenario["jax"][key]
        assert _timeless(got) == _timeless(want), key
    assert scenario["port"]["degraded"]["degraded"] and not scenario["port"]["status"]["degraded"]


def test_cluster_prometheus_names_equal(scenario):
    got = _prom_names(scenario["port"]["prom"], "metrics_tpu_cluster_", 'cluster="scen"')
    assert got == _prom_names(scenario["jax"]["prom"], "metrics_tpu_cluster_", 'cluster="scen"')
    assert {"metrics_tpu_cluster_epoch", "metrics_tpu_cluster_migrations_total",
            "metrics_tpu_cluster_replica_losses_total"} <= set(got)


def test_recovered_reads_equal_the_replays(scenario):
    log = scenario["port"]["log"]
    assert len(log) == len(scenario["jax"]["log"]) and all(
        a[0] == b[0] and all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))
        for a, b in zip(log, scenario["jax"]["log"]))
    port_oracle = msv.offline_replay(_port_small, log)
    jax_oracle = jsv.offline_replay(lambda: _small(M), log)
    for tid, doc in scenario["port"]["reads"].items():
        assert doc["status"] == 200 and doc["last_applied_step"] == 2, doc
        for name, want in port_oracle[tid].items():
            got = np.asarray(doc["values"][name], dtype=want.dtype)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_allclose(got, jax_oracle[tid][name], rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------- #
# HTTP: the redirect and the coordinator's endpoints
# --------------------------------------------------------------------------- #
def _http(url, body=None):
    req = urllib.request.Request(url, data=body, method="POST" if body is not None else "GET",
                                 headers={"Content-Type": "application/x-npz"} if body is not None else {})
    opener = urllib.request.build_opener(_NoRedirect)
    try:
        with opener.open(req, timeout=30) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read().decode())
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), json.loads(err.read().decode())


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, *args, **kwargs):
        return None


def _http_script(pkg, sv, cl, **kw):
    servers = {rid: sv.IngestServer(pkg.TenantSet(_small(pkg, **kw), capacity=4), name=f"http-{rid}")
               for rid in ("r0", "r1")}
    for s in servers.values():
        s._life.start()  # no dispatcher: nothing compiles, nothing applies
    coordinator = cl.ClusterCoordinator(servers, name="http")
    status_server = coordinator.serve_status(port=0)
    out = []
    try:
        tenant = "t-redirect"
        owner = coordinator.owner(tenant)
        other = next(r for r in servers if r != owner)
        body = sv.encode_npz(*_batch(np.random.default_rng(230)))
        for path, data in ((f"/ingest/{tenant}", body), (f"/read/{tenant}", None)):
            status, headers, doc = _http(servers[other].url + path, data)
            out.append((status, headers.get(SHARD_EPOCH_HEADER),
                        headers.get("Location", "").replace(servers[owner].url, "<owner>"), doc))
        status, headers, doc = _http(servers[owner].url + f"/ingest/{tenant}", body)
        out.append((status, headers.get(SHARD_EPOCH_HEADER), sorted(doc)))
        status, headers, doc = _http(servers[owner].url + "/read/ghost-of-owner")
        out.append((status, headers.get(SHARD_EPOCH_HEADER), doc.get("error", "")[:16] if status != 307 else doc))
        for path in ("/shardmap", "/healthz", "/status.json", "/nowhere"):
            status, _, doc = _http(status_server.url + path)
            out.append((path, status, sorted(doc), doc.get("epoch"), doc.get("replicas")))
    finally:
        status_server.stop()
        for s in servers.values():
            s.stop(drain=False, timeout=1.0)
    return out


def test_http_redirects_and_endpoints_equal_the_jax_packages():
    got = _http_script(mt, msv, tcl, **CPU)
    want = _http_script(M, jsv, jcl)
    for a, b in zip(got, want):
        if isinstance(a[0], str) and a[0] == "/status.json":
            assert a[:3] == b[:3]
        else:
            assert a == b
    assert got[0][0] == 307 and got[0][1] == "1" and got[0][2] == "<owner>/ingest/t-redirect"
    assert got[0][3] == {"error": "not_owner", "tenant": "t-redirect", "owner": got[0][3]["owner"], "epoch": 1}


# --------------------------------------------------------------------------- #
# the port alone
# --------------------------------------------------------------------------- #
@pytest.fixture
def cluster(tmp_path):
    made = []

    def make(n=2, name="cl", root=False):
        coordinator = tcl.ClusterCoordinator(
            {f"r{i}": msv.IngestPipeline(_port_small(), name=f"{name}-r{i}") for i in range(n)},
            name=name, checkpoint_root=str(tmp_path / "ckpt") if root else None).start()
        made.append(coordinator)
        return coordinator, tcl.ClusterClient(dict(coordinator.replicas), coordinator)

    yield make
    for coordinator in made:
        coordinator.stop(drain=False, timeout=5.0)


def _post_stream(client, tenants, steps, seed):
    rng = np.random.default_rng(seed)
    log = []
    for _ in range(steps):
        for tid in tenants:
            preds, target = _batch(rng)
            doc = client.post_with_retry(tid, preds, target, max_attempts=400, max_backoff_s=0.01)
            assert doc.get("admitted"), doc
            log.append((tid, (preds, target), {}))
    return log


def _assert_replay(client, log):
    oracle = msv.offline_replay(_port_small, log)
    for tid, ref in oracle.items():
        doc = client.read(tid, max_staleness_steps=0, timeout_s=30)
        assert doc["status"] == 200, doc
        for name, want in ref.items():
            np.testing.assert_array_equal(np.asarray(doc["values"][name], dtype=want.dtype), want, err_msg=tid)


def test_migration_under_concurrent_posts_loses_and_doubles_nothing(cluster):
    coordinator, client = cluster(name="under-posts")
    tenants = [f"t{i}" for i in range(6)]
    log = _post_stream(client, tenants, 1, seed=240)
    moving = [t for t in tenants if coordinator.owner(t) == "r0"][:2] or tenants[:1]
    logs = []

    def keep_posting():
        logs.append(_post_stream(tcl.ClusterClient(dict(coordinator.replicas), coordinator), moving, 6, seed=241))

    worker = threading.Thread(target=keep_posting)
    worker.start()
    records = [coordinator.migrate(t, "r1" if coordinator.owner(t) == "r0" else "r0") for t in moving]
    worker.join(60)
    assert all(r.outcome == "committed" for r in records), [r.to_dict() for r in records]
    _assert_replay(client, log + logs[0])
    for t in moving:
        doc = client.read(t)
        assert doc["last_applied_step"] == 7  # the ledger moved with the tenant


@pytest.mark.parametrize("site", ["cluster/fence", "cluster/export", "cluster/transfer", "cluster/import",
                                  "cluster/cutover"])
def test_a_fault_at_each_phase_rolls_back_then_the_retry_commits(cluster, site):
    coordinator, client = cluster(name="sweep")
    tenants = ["t0", "t1", "t2"]
    log = _post_stream(client, tenants, 2, seed=242)
    for replica in coordinator.replicas.values():
        assert replica.pipeline.drain(30.0)
    src = coordinator.owner("t0")
    dst = next(r for r in coordinator.replicas if r != src)
    epoch = coordinator.shard_map.epoch
    with chaos.plan([chaos.FaultSpec(site=site, kind="error", nth=1, times=1)], seed=0) as armed:
        record = coordinator.migrate("t0", dst)
    assert record.outcome == "aborted" and record.phase == site.split("/")[1]
    assert [e.site for e in armed.log] == [site]
    assert coordinator.owner("t0") == src and coordinator.shard_map.epoch == epoch
    assert "t0" not in map(str, coordinator.replicas[dst].tenant_ids())
    assert "t0" not in coordinator.replicas[src].pipeline.fenced_tenants()
    assert coordinator.migrate("t0", dst).outcome == "committed"
    _assert_replay(client, log)


def test_a_source_that_dies_mid_move_aborts_cleanly(cluster):
    coordinator, client = cluster(name="crash")
    _post_stream(client, ["t0", "t1"], 2, seed=243)
    src = coordinator.owner("t0")
    dst = next(r for r in coordinator.replicas if r != src)
    record = coordinator.migrate("t0", dst, on_phase=lambda ph: ph == "export" and coordinator.replicas[src].kill())
    assert record.outcome == "aborted" and record.phase == "export"
    assert "t0" not in map(str, coordinator.replicas[dst].tenant_ids())
    assert coordinator.status()["degraded"]
    with pytest.raises(tcl.ReplicaLost):
        coordinator.replicas[src].export_tenant("t0")


def test_scale_out_rebalance_moves_load_onto_the_new_replica(cluster):
    coordinator, client = cluster(name="grow")
    tenants = [f"t{i}" for i in range(8)]
    log = _post_stream(client, tenants, 2, seed=244)
    for replica in coordinator.replicas.values():
        assert replica.pipeline.drain(30.0)
    coordinator.add_replica("r2", msv.IngestPipeline(_port_small(), name="grow-r2"))
    client.add_target("r2", coordinator.replicas["r2"])
    records = coordinator.rebalance(tolerance=0.10)
    assert records and all(r.outcome == "committed" for r in records)
    assert coordinator.status()["shard_sizes"]["r2"] > 0
    _assert_replay(client, log)


def _cli(main, capsys, argv):
    code = main(argv)
    return code, json.loads(capsys.readouterr().out)


def test_cli_plan_equals_the_jax_packages(capsys):
    code, got = _cli(tcli.main, capsys, ["plan", "--demo", "--device", "cpu"])
    assert code == 0
    code, want = _cli(jcli.main, capsys, ["plan", "--demo"])
    assert got == want and set(got["occupancy"]) == {"r0", "r1"}


@pytest.mark.parametrize("argv", [
    ["status", "--demo", "--device", "cpu"],
    ["migrate", "--demo", "--tenant", "tenant-0", "--dst", "r0", "--device", "cpu"],
    ["rebalance", "--demo", "--add-replica", "--device", "cpu"],
])
def test_cli_verbs_run_on_the_cpu(capsys, argv):
    if argv[0] == "migrate" and tcl.ShardMap(("r0", "r1")).owner("tenant-0") == "r0":
        argv = [a if a != "r0" else "r1" for a in argv]
    code, doc = _cli(tcli.main, capsys, argv)
    assert code == 0
    if argv[0] == "status":
        assert sorted(doc["replicas"]) == ["r0", "r1"] and sum(doc["shard_sizes"].values()) == 8
    elif argv[0] == "migrate":
        assert doc["outcome"] == "committed" and doc["phase"] == "done"
    else:
        assert set(doc["shard_sizes"]) == {"r0", "r1", "r2"} and sum(doc["shard_sizes"].values()) == 8


@pytest.mark.skipif(torch.cuda.is_available(), reason="the card is present: the default device works")
def test_cli_demo_without_a_card_needs_device_cpu():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["plan", "--demo"])

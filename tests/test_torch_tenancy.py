"""The port's TenantSet against the JAX package's.

Ports the cases of ``tests/tenancy/test_tenant_set.py``, ``_checkpoint.py``,
``_sync.py``, ``_chaos.py``, ``_observability.py`` and ``_sharding.py`` (all
but the analyzer's E110 case, which waits for analysis, A21) and
``tests/sketches/test_sketch_tenancy.py`` to ``metrics_tpu_torch.tenancy``,
and holds the port against the JAX package on the same seeded numpy
streams:

- per-tenant computes equal to the JAX TenantSet's (bitwise for the integer
  counts and their ratios, within the parity harness's RTOL/ATOL for float
  sums), and the same ``TenantStats`` and ``tenancy/*`` events for the same
  lifecycle;
- ``classify_tenant_member`` equal to the JAX package's for every
  ``INVENTORY`` entry;
- untouched rows bit for bit untouched; a stacked member runs as one vmapped
  call per bucket, never as a per-tenant loop;
- the stacked sync and the stacked incremental sync in one gloo world of 4
  CPU ranks (``tests/helpers/torch_tenancy.py``), with the collective count
  constant in the tenant count;
- B1's ``vmap`` rule: a vmapped plain ``binned_counts`` equals a loop of
  unbatched calls, bit for bit.

JAX TenantSets stay small (each bucket compiles); their templates keep the
engines at their defaults, which the tenant classification reads.
"""
from __future__ import annotations

import gc
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as M
import metrics_tpu_torch as mt
from metrics_tpu.core.engine import classify_tenant_member as jax_classify
from metrics_tpu_torch import checkpoint as ck
from metrics_tpu_torch import observability as obs
from metrics_tpu_torch.checkpoint import io as ckio
from metrics_tpu_torch.core.engine import PATH_EAGER, PATH_TENANT, classify_tenant_member
from metrics_tpu_torch.observability.instruments import InstrumentRegistry
from metrics_tpu_torch.ops.classification import binned_counts as B1
from metrics_tpu_torch.ops.kernels import launch_counts
from metrics_tpu_torch.parallel.sync import sync_stacked_states
from metrics_tpu_torch.resilience import FaultSpec, chaos
from metrics_tpu_torch.resilience.chaos import KNOWN_SITES, ChaosError
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from tests.helpers import torch_dist as td
from tests.helpers import torch_tenancy as tt
from tests.helpers.torch_parity import ATOL, RTOL, _reason, reference, twin
from tests.helpers.torch_port import assert_bitwise, one_torch_thread  # noqa: F401  (the module fixture)
from tests.helpers.torch_twins import TWINS
from tests.observability.test_exporters import _StrictPromParser

pytestmark = [pytest.mark.usefixtures("one_torch_thread"), pytest.mark.filterwarnings("ignore")]

CPU = dict(device="cpu")
JAX_EAGER = dict(compiled_update=False, compiled_compute=False)
WORLD = 4
TinyMean, TinyMax = tt.TinyMean, tt.TinyMax


def _tiny_set(capacity, n_admit=None):
    ts = mt.TenantSet(mt.MetricCollection({"mean": TinyMean(**CPU), "mx": TinyMax(**CPU)}), capacity=capacity)
    for i in range(n_admit if n_admit is not None else capacity):
        ts.admit(f"t{i}")
    return ts


def _rows(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


# ----------------------------------------------------------- classification --
def test_dense_elementwise_metric_stacks():
    path, reason = classify_tenant_member(TinyMean(**CPU))
    assert path == PATH_TENANT and "stackable" in reason


def test_catbuffer_metric_is_eager():
    assert classify_tenant_member(mt.CatMetric(**CPU))[0] == PATH_EAGER


def test_partition_view_has_tenant_section():
    view = _tiny_set(4).partition_view()
    assert set(view["tenant"]) == {"mean", "mx"}
    assert all(info["path"] == PATH_TENANT for info in view["tenant"].values())
    # a plain collection's dispatcher has no tenant section
    assert "tenant" not in mt.MetricCollection({"mean": TinyMean(**CPU)}).engine_stats()["partition"]


def test_eager_member_reason_is_reported():
    ts = mt.TenantSet(mt.MetricCollection({"mean": TinyMean(**CPU), "cat": mt.CatMetric(**CPU)}), capacity=2)
    info = ts.partition_view()["tenant"]["cat"]
    assert info["path"] == PATH_EAGER and info["reason"]


@pytest.mark.parametrize("name", sorted(TWINS))
def test_classify_tenant_member_matches_jax(name):
    """The path and the reason of every INVENTORY entry, as the JAX engine
    classifies it (the JAX package's heavy-kernel suffix dropped, as the
    parity harness drops it)."""
    got = classify_tenant_member(twin(name))
    want = jax_classify(reference(name))
    assert (got[0], _reason(got[1])) == (want[0], _reason(want[1]))


# ------------------------------------------------------------------- parity --
@pytest.mark.parametrize("k", [1, 37, 64, 1000])
def test_ragged_occupancy_bitwise_parity(k):
    """k of 1024 active tenants: the stacked dispatch is bit for bit k
    independent pure-protocol streams."""
    ts = _tiny_set(1024)
    ids = ts.tenant_ids()
    rng = np.random.default_rng(k)
    ref_mean, ref_max = TinyMean(**CPU), TinyMax(**CPU)
    states, touched = {}, set()
    for _ in range(2):
        sel = rng.choice(1024, size=k, replace=False)
        vals = _rows(rng.normal(size=(k, 4)))
        ts.update([ids[i] for i in sel], vals)
        for j, i in enumerate(sel):
            sm, sx = states.get(i, (ref_mean.init_state(), ref_max.init_state()))
            states[i] = (ref_mean.update_state(sm, vals[j]), ref_max.update_state(sx, vals[j]))
            touched.add(int(i))
    out = ts.compute([ids[i] for i in sorted(touched)])
    for i in sorted(touched):
        assert_bitwise(out[ids[i]]["mean"], ref_mean.compute_state(states[i][0]))
        assert_bitwise(out[ids[i]]["mx"], ref_max.compute_state(states[i][1]))


def test_real_collection_parity():
    k, b, c = 3, 16, 4
    make = lambda: mt.MetricCollection({"acc": mt.Accuracy(num_classes=c, **CPU),  # noqa: E731
                                        "mse": mt.MeanSquaredError(**CPU)})
    ts = mt.TenantSet(make(), capacity=8)
    refs = {f"t{i}": make() for i in range(k)}
    for tid in refs:
        ts.admit(tid)
    rng = np.random.default_rng(0)
    for _ in range(3):
        preds = torch.from_numpy(rng.integers(0, c, (k, b)).astype(np.int32))
        target = torch.from_numpy(rng.integers(0, c, (k, b)).astype(np.int32))
        ts.update(list(refs), preds, target)
        for j, coll in enumerate(refs.values()):
            coll.update(preds[j], target[j])
    out = ts.compute()
    for tid, coll in refs.items():
        expect = coll.compute()
        assert set(out[tid]) == set(expect)
        for name in expect:
            assert_bitwise(out[tid][name], expect[name])


def _config2(pkg, **kw):
    return pkg.MetricCollection({
        "acc": pkg.Accuracy(num_classes=10, average="micro", **kw),
        "f1": pkg.F1Score(num_classes=10, average="macro", **kw),
        "precision": pkg.Precision(num_classes=10, average="macro", **kw),
        "recall": pkg.Recall(num_classes=10, average="macro", **kw),
    })


def _assert_results(got, want, exact):
    if isinstance(want, (list, tuple)):
        for g, w in zip(got, want):
            _assert_results(g, w, exact)
        return
    g, w = got.numpy(), np.asarray(want)
    if exact:
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def jax_config2_run():
    """The JAX TenantSet of config2 on a seeded ragged stream (one bucket
    width, one compute), and the stream."""
    rng = np.random.default_rng(12)
    ids = [f"t{i}" for i in range(6)]
    stream = []
    for sel in (ids[:4], ids[2:6], ids[:3]):
        stream.append((sel, rng.normal(size=(len(sel), 64, 10)).astype(np.float32),
                       rng.integers(0, 10, (len(sel), 64)).astype(np.int32)))
    ts = M.TenantSet(_config2(M), capacity=8)
    for tid in ids:
        ts.admit(tid)
    for sel, x, y in stream:
        ts.update(sel, jnp.asarray(x), jnp.asarray(y))
    return ids, stream, ts.compute(ids), ts.stats


def test_per_tenant_computes_equal_the_jax_tenant_set(jax_config2_run):
    ids, stream, want, jax_stats = jax_config2_run
    ts = mt.TenantSet(_config2(mt, **CPU), capacity=8)
    for tid in ids:
        ts.admit(tid)
    for sel, x, y in stream:
        ts.update(sel, torch.from_numpy(x), torch.from_numpy(y))
    got = ts.compute(ids)
    for tid in ids:
        assert set(got[tid]) == set(want[tid])
        for name in want[tid]:
            # integer counts, and the ratios of them within the parity bound
            _assert_results(got[tid][name], want[tid][name], exact=name == "acc")
    for lname, st in ts.stacked_states.items():
        assert all(v.dtype == torch.int32 for v in st.values())
    assert ts.stats == mt.tenancy.TenantStats(**vars(jax_stats))


def test_binned_ap_tenant_set_equals_jax_and_launches_batched():
    """The dry run's BinnedAveragePrecision stacks; on the CPU its counts
    come from the plain version of B1's batched launch, once a dispatch."""
    rng = np.random.default_rng(13)
    ids = ["a", "b", "c"]
    x = rng.uniform(0, 1, (3, 32, 8)).astype(np.float32)
    y = rng.integers(0, 8, (3, 32)).astype(np.int64)
    ref = M.TenantSet(M.BinnedAveragePrecision(num_classes=8, thresholds=21), capacity=4)
    ts = mt.TenantSet(mt.BinnedAveragePrecision(num_classes=8, thresholds=21, **CPU), capacity=4)
    for s in (ref, ts):
        for tid in ids:
            s.admit(tid)
    ref.update(ids, jnp.asarray(x), jnp.asarray(y))
    before = launch_counts()
    ts.update(ids, torch.from_numpy(x), torch.from_numpy(y))
    assert launch_counts() == before  # the CPU launches nothing
    for lname, st in ts.stacked_states.items():
        for k, v in st.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(ref.stacked_states[lname][k]))
    want, got = ref.compute(), ts.compute()
    for tid in ids:
        _assert_results(got[tid]["BinnedAveragePrecision"], want[tid]["BinnedAveragePrecision"], exact=False)


def test_stacked_member_never_loops_over_tenants(monkeypatch):
    """One vmapped update_state call serves a dispatch of every tenant."""
    ts = _tiny_set(16)
    calls = []
    leader = ts.template._metrics["mean"]
    real = type(leader).update_state

    def counting(self, state, *args, **kwargs):
        calls.append(self)
        return real(self, state, *args, **kwargs)

    monkeypatch.setattr(type(leader), "update_state", counting)
    ts.update(ts.tenant_ids(), _rows(np.ones((16, 4))))
    ts.update(ts.tenant_ids(), _rows(np.ones((16, 4))))
    assert len(calls) == 2


def test_unvmappable_stacked_member_raises():
    """A stacked member whose update cannot run under vmap is an error, not
    a quiet per-tenant loop."""

    class HostRead(TinyMean):
        def update(self, values):
            super().update(values)
            if float(values.sum()) > 1e9:  # a read back to the host
                raise AssertionError

    ts = mt.TenantSet(mt.MetricCollection({"m": HostRead(**CPU)}), capacity=4)
    ts.admit("a")
    assert ts.partition_view()["tenant"]["m"]["path"] == PATH_TENANT
    with pytest.raises(MetricsUserError, match="cannot be vmapped or captured"):
        ts.update(["a"], _rows(np.ones((1, 4))))
    assert ts.stats.eager_tenant_updates == 0


def test_batched_broadcast_and_static_leaves():
    class Scaled(mt.Metric):
        full_state_update = False

        def __init__(self, **kw):
            super().__init__(**kw)
            self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")

        def update(self, values, weight, gain):
            self.total = self.total + (values * weight).sum() * gain

        def compute(self):
            return self.total

    ts = mt.TenantSet(mt.MetricCollection(Scaled(**CPU)), capacity=4)
    ts.admit("a")
    ts.admit("b")
    ts.update(["a", "b"], _rows([[1.0, 2.0], [3.0, 4.0]]), _rows([2.0, 0.5]), 3.0)
    out = ts.compute()
    assert float(out["a"]["Scaled"]) == pytest.approx((1 + 2) * 2 * 3)
    assert float(out["b"]["Scaled"]) == pytest.approx((3 + 4) * 0.5 * 3)
    ts.update(["a", "b"], _rows([[1.0, 1.0, 1.0], [2.0, 2.0, 2.0]]), _rows([1.0, 2.0, 3.0]), 1.0)
    out = ts.compute()
    assert float(out["a"]["Scaled"]) == pytest.approx((1 + 2) * 2 * 3 + 6)
    assert float(out["b"]["Scaled"]) == pytest.approx((3 + 4) * 0.5 * 3 + 12)


# -------------------------------------------------------------- step caching --
def test_one_step_across_occupancy_churn():
    ts = _tiny_set(1024)
    ids = ts.tenant_ids()
    vals = _rows(np.random.default_rng(0).normal(size=(37, 4)))
    ts.update(ids[:37], vals)
    assert ts.stats.compiles == 1
    for off in (1, 101, 500):
        ts.update(ids[off:off + 37], vals)
    ts.update(ids[:33], vals[:33])
    assert ts.stats.compiles == 1 and ts.stats.cache_hits == 4 and ts.stats.last_bucket == 64


def test_bucket_transition_builds_once_per_width():
    ts = _tiny_set(64)
    ids = ts.tenant_ids()
    vals = _rows(np.ones((40, 4)))
    ts.update(ids[:40], vals)
    ts.update(ids[:16], vals[:16])
    ts.update(ids[:9], vals[:9])
    assert ts.stats.compiles == 2
    ts.update(ids[:10], vals[:10])
    assert ts.stats.compiles == 2


def test_reset_evict_admit_never_rebuild_once_warm():
    ts = _tiny_set(64)
    ids = ts.tenant_ids()
    vals = _rows(np.ones((5, 4)))
    ts.update(ids[:5], vals)
    ts.reset(ids[:5])
    ts.evict(ids[0])
    ts.admit(ids[0])
    warm = ts.stats.compiles
    for _ in range(3):
        ts.update(ids[:5], vals)
        ts.reset(ids[1:6])
        ts.evict(ids[2])
        ts.admit(ids[2])
    assert ts.stats.compiles == warm
    stats = ts._dispatcher.stats
    assert stats.builds == 1 and stats.repartitions == 0 and stats.migrations == 0 and stats.stable_hits > 0


def test_compute_step_is_cached():
    ts = _tiny_set(16)
    ids = ts.tenant_ids()
    ts.update(ids[:3], _rows(np.ones((3, 4))))
    before = ts.stats.compiles
    ts.compute(ids[:3])
    assert ts.stats.compiles == before + 1
    ts.compute(ids[1:4])
    ts.compute(ids[:4])
    assert ts.stats.compiles == before + 1 and ts.stats.cache_hits == 2


# ------------------------------------------------------------- immutability --
def test_absent_tenants_rows_are_bitwise_untouched():
    ts = _tiny_set(8)
    ids = ts.tenant_ids()
    initial = {ln: {k: v.clone() for k, v in st.items()} for ln, st in ts.stacked_states.items()}
    vals = _rows(np.random.default_rng(0).normal(size=(2, 4)))
    for _ in range(3):
        ts.update([ids[0], ids[2]], vals)
    untouched = [1, 3, 4, 5, 6, 7]
    for ln, st in ts.stacked_states.items():
        for k, leaf in st.items():
            assert_bitwise(leaf[untouched], initial[ln][k][untouched])


def test_padding_rows_land_in_the_scratch_row_only():
    """A 3-tenant dispatch runs the 4-wide bucket: its padding row writes the
    scratch row past the capacity, which no tenant owns."""
    ts = _tiny_set(8)
    ids = ts.tenant_ids()
    before = [leaf.clone() for leaves, _ in ts._flat.values() for leaf in leaves]
    ts.update(ids[4:7], _rows(np.ones((3, 4))))
    after = [leaf for leaves, _ in ts._flat.values() for leaf in leaves]
    for b, a in zip(before, after):
        assert a.shape[0] == 9
        changed = sorted({int(i) for i in torch.nonzero(a != b)[:, 0].tolist()})
        assert set(changed) <= {4, 5, 6, 8}
    assert ts.tenant_ids() == ids and ts.stats.last_bucket == 4


def test_reset_of_some_leaves_others_mid_streak():
    ts = _tiny_set(8)
    ids = ts.tenant_ids()
    ts.update(ids[:3], _rows(np.ones((3, 4))))
    before = ts.stacked_states["mean"]["total"].clone()
    ts.reset([ids[1]])
    after = ts.stacked_states["mean"]["total"]
    assert float(after[1]) == 0.0
    assert_bitwise(after[[0, 2]], before[[0, 2]])


def test_evicted_slot_is_scrubbed_for_the_next_tenant():
    ts = _tiny_set(4, n_admit=1)
    ts.update(["t0"], _rows(np.ones((1, 4))))
    ts.evict("t0")
    ts.admit("newcomer")
    assert float(ts.compute(["newcomer"])["newcomer"]["mean"]) == 0.0


# -------------------------------------------------------------- export/import --
def test_export_import_round_trip_is_bitwise():
    ts = _tiny_set(8)
    ids = ts.tenant_ids()
    ts.update(ids[:2], _rows(np.random.default_rng(1).normal(size=(2, 4))))
    snap = ts.export_tenant(ids[0])
    other = _tiny_set(4, n_admit=0)
    other.import_tenant("moved", snap)
    a, b = ts.compute([ids[0]])[ids[0]], other.compute(["moved"])["moved"]
    for name in a:
        assert_bitwise(a[name], b[name])
    assert other.tenant_update_counts()["moved"] == 1


def test_import_does_not_touch_other_rows():
    ts = _tiny_set(8)
    ids = ts.tenant_ids()
    ts.update(ids[:2], _rows(np.ones((2, 4))))
    before = ts.stacked_states["mean"]["total"].clone()
    ts.import_tenant(ids[3], ts.export_tenant(ids[0]))
    after = ts.stacked_states["mean"]["total"]
    assert_bitwise(after[[0, 1, 2]], before[[0, 1, 2]])
    assert float(after[3]) == float(before[0])


# ----------------------------------------------------------- mixed and eager --
def test_mixed_stacked_and_eager_parity():
    ts = mt.TenantSet(mt.MetricCollection({"mean": TinyMean(**CPU), "cat": mt.CatMetric(**CPU)}), capacity=4)
    ts.admit("a")
    ts.admit("b")
    vals = _rows([[1.0, 2.0], [3.0, 4.0]])
    ts.update(["a", "b"], vals)
    ts.update(["b"], vals[:1] * 10)
    out = ts.compute()
    assert float(out["a"]["mean"]) == pytest.approx(1.5)
    assert out["a"]["cat"].tolist() == [1.0, 2.0] and out["b"]["cat"].tolist() == [3.0, 4.0, 10.0, 20.0]
    assert ts.stats.eager_tenant_updates == 3


def test_fully_eager_template_works():
    ts = mt.TenantSet(mt.CatMetric(**CPU), capacity=2)
    ts.admit(0)
    ts.update([0], _rows([[1.0, 2.0]]))
    assert ts.compute()[0]["CatMetric"].tolist() == [1.0, 2.0]
    assert ts.stats.compiles == 0


# -------------------------------------------------------------------- errors --
def test_user_errors():
    ts = _tiny_set(4)
    with pytest.raises(MetricsUserError, match="duplicate tenant"):
        ts.update(["t0", "t0"], torch.zeros((2, 4)))
    with pytest.raises(MetricsUserError, match="not admitted"):
        ts.update(["ghost"], torch.zeros((1, 4)))
    with pytest.raises(MetricsUserError, match="already admitted"):
        ts.admit("t0")
    with pytest.raises(MetricsUserError, match="at capacity"):
        ts.admit("overflow")
    with pytest.raises(MetricsUserError, match="not admitted"):
        ts.evict("ghost")
    with pytest.raises(MetricsUserError, match="hashable"):
        ts.update(["t0"], torch.zeros((1, 4)), {"unhashable", "set"})
    empty = _tiny_set(4, n_admit=0)
    for bad in (True, 1.5, ("a",)):
        with pytest.raises(MetricsUserError, match="str or int"):
            empty.admit(bad)
    with pytest.raises(MetricsUserError, match="Metric or MetricCollection"):
        mt.TenantSet({"acc": mt.Accuracy(**CPU)}, capacity=4)
    with pytest.raises(MetricsUserError, match="capacity"):
        mt.TenantSet(TinyMean(**CPU), capacity=0)


def test_empty_dispatch_is_a_noop():
    ts = _tiny_set(4)
    ts.update([], torch.zeros((0, 4)))
    ts.reset([])
    assert ts.stats.dispatches == 0 and ts.stats.compiles == 0


# ---------------------------------------------------------------- sketches --
def _feed(ts, tenant_rows):
    for tid, rows in tenant_rows.items():
        for row in rows:
            ts.apply_batch([tid], torch.from_numpy(row)[None], auto_admit=True)


def test_stacked_quantile_parity_and_isolation():
    rng = np.random.default_rng(21)
    ts = mt.TenantSet(mt.Quantile(q=0.5, **CPU), capacity=4)
    rows = {"lo": rng.uniform(1.0, 10.0, (4, 32)).astype(np.float32),
            "hi": rng.uniform(100.0, 1000.0, (4, 32)).astype(np.float32)}
    _feed(ts, rows)
    out = ts.compute(["lo", "hi"])
    for tid, data in rows.items():
        oracle = mt.Quantile(q=0.5, **CPU)
        for row in data:
            oracle.update(torch.from_numpy(row))
        assert_bitwise(out[tid]["Quantile"], oracle.compute())
    assert float(out["lo"]["Quantile"]) < 11.0 < 99.0 < float(out["hi"]["Quantile"])


def test_stacked_distinct_count_parity():
    rng = np.random.default_rng(22)
    ts = mt.TenantSet(mt.DistinctCount(**CPU), capacity=4)
    keys = {"a": rng.choice(10**6, size=(2, 256), replace=False).astype(np.int32),
            "b": rng.choice(10**6, size=(2, 64), replace=False).astype(np.int32)}
    _feed(ts, keys)
    out = ts.compute(["a", "b"])
    for tid, data in keys.items():
        oracle = mt.DistinctCount(**CPU)
        for row in data:
            oracle.update(torch.from_numpy(row))
        assert_bitwise(out[tid]["DistinctCount"], oracle.compute())


def test_sketch_export_import_and_read_quantiles():
    rng = np.random.default_rng(23)
    ts = mt.TenantSet(mt.Quantile(q=0.5, **CPU), capacity=4)
    data = rng.uniform(1.0, 100.0, (8, 64)).astype(np.float32)
    _feed(ts, {"t": data})
    ts2 = mt.TenantSet(mt.Quantile(q=0.5, **CPU), capacity=4)
    ts2.import_tenant("d", ts.export_tenant("t"))
    assert_bitwise(ts.compute(["t"])["t"]["Quantile"], ts2.compute(["d"])["d"]["Quantile"])
    qs = [0.1, 0.5, 0.99]
    got = ts.read_quantiles("t", qs)
    assert set(got) == {"Quantile"}
    np.testing.assert_allclose(got["Quantile"], np.quantile(data.ravel(), qs, method="inverted_cdf"), rtol=0.011)
    with pytest.raises(MetricsUserError):
        ts.read_quantiles("missing", [0.5])
    with pytest.raises(MetricsUserError):
        ts.read_quantiles("t", [1.5])
    with pytest.raises(MetricsUserError):
        ts.read_quantiles("t", [])
    dc = mt.TenantSet(mt.DistinctCount(**CPU), capacity=2)
    _feed(dc, {"t": rng.integers(0, 100, (1, 16)).astype(np.int32)})
    assert dc.read_quantiles("t", [0.5]) == {}


# ---------------------------------------------------------------- checkpoint --
def _populated_set(capacity=8):
    ts = mt.TenantSet(mt.MetricCollection({"mean": TinyMean(**CPU)}), capacity=capacity)
    for tid in ("a", "b", "c"):
        ts.admit(tid)
    ts.update(["a", "b", "c"], torch.arange(12, dtype=torch.float32).reshape(3, 4))
    ts.update(["b"], torch.full((1, 4), 100.0))
    return ts


def _fresh_like(capacity=8):
    ts = mt.TenantSet(mt.MetricCollection({"mean": TinyMean(**CPU)}), capacity=capacity)
    for tid in ("a", "b", "c"):
        ts.admit(tid)
    return ts


def _corrupt_latest(root):
    step_dir = ckio.step_dir(root, ck.available_steps(root)[-1])
    path = os.path.join(step_dir, next(n for n in os.listdir(step_dir) if n.endswith(".npz")))
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))


def test_tenant_set_save_verify_restore_parity(tmp_path):
    root = str(tmp_path / "ckpt")
    ts = _populated_set()
    before = ts.compute()
    ck.save_checkpoint(ts, root, world_size=1, shard_index=0)
    assert ck.verify_checkpoint(root).ok
    fresh = _fresh_like()
    info = ck.restore_checkpoint(fresh, root, host_count=1)
    assert info.fallback_from is None
    after = fresh.compute()
    for tid in ("a", "b", "c"):
        assert_bitwise(before[tid]["mean"], after[tid]["mean"])
    assert fresh.tenant_update_counts() == ts.tenant_update_counts()
    assert fresh.tenant_ids() == ts.tenant_ids()


def test_restore_does_not_rebuild_steps(tmp_path):
    root = str(tmp_path / "ckpt")
    ck.save_checkpoint(_populated_set(), root, world_size=1, shard_index=0)
    fresh = _fresh_like()
    fresh.update(["a", "b", "c"], torch.ones((3, 4)))
    compiles = fresh.stats.compiles
    ck.restore_checkpoint(fresh, root, host_count=1)
    fresh.update(["a", "b", "c"], torch.ones((3, 4)))
    assert fresh.stats.compiles == compiles and fresh.stats.cache_hits >= 1


def test_tenant_set_falls_back_to_older_verifiable_step(tmp_path):
    root = str(tmp_path / "ckpt")
    ts = _populated_set()
    ck.save_checkpoint(ts, root, world_size=1, shard_index=0)
    good = ts.compute()
    ts.update(["a"], torch.full((1, 4), 7.0))
    ck.save_checkpoint(ts, root, world_size=1, shard_index=0)
    bad_step = ck.available_steps(root)[-1]
    _corrupt_latest(root)
    fresh = _fresh_like()
    info = ck.restore_checkpoint(fresh, root, host_count=1)
    assert info.fallback_from == bad_step and info.step == ck.available_steps(root)[0]
    after = fresh.compute()
    for tid in ("a", "b", "c"):
        assert_bitwise(good[tid]["mean"], after[tid]["mean"])
    with pytest.raises(ck.CheckpointCorruptError):
        ck.restore_checkpoint(_fresh_like(), root, step=bad_step, host_count=1)


def test_tenant_set_refusals(tmp_path):
    root = str(tmp_path / "ckpt")
    ck.save_checkpoint(_populated_set(capacity=8), root, world_size=1, shard_index=0)
    with pytest.raises(ck.CheckpointMismatchError):
        ck.restore_checkpoint(_fresh_like(capacity=16), root, host_count=1)
    with pytest.raises(ck.CheckpointMismatchError, match="export_tenant"):
        ck.restore_checkpoint(_fresh_like(), root, host_count=2, host_index=0)
    ts = mt.TenantSet(mt.MetricCollection({"mean": TinyMean(**CPU), "cat": mt.CatMetric(**CPU)}), capacity=4)
    ts.admit("a")
    ts.update(["a"], torch.ones((1, 4)))
    with pytest.raises(MetricsUserError, match="E110"):
        ck.save_checkpoint(ts, str(tmp_path / "eager"), world_size=1, shard_index=0)


def test_tenant_set_snapshots_restore_across_packages(tmp_path, jax_config2_run):
    """A config2 TenantSet snapshot of either package restores in the other:
    the stacked int32 counts bit for bit, the slot table and update counts
    equal, the manifests equal apart from checksums and sizes."""
    from metrics_tpu import checkpoint as jck
    from metrics_tpu.checkpoint import io as jio

    ids, stream, _, _ = jax_config2_run
    jts = M.TenantSet(_config2(M), capacity=8)
    pts = mt.TenantSet(_config2(mt, **CPU), capacity=8)
    for s in (jts, pts):
        for tid in ids:
            s.admit(tid)
    for sel, x, y in stream:
        jts.update(sel, jnp.asarray(x), jnp.asarray(y))
        pts.update(sel, torch.from_numpy(x), torch.from_numpy(y))
    jck.save_checkpoint(jts, str(tmp_path / "jax"), world_size=1, shard_index=0)
    ck.save_checkpoint(pts, str(tmp_path / "port"), world_size=1, shard_index=0)
    manifests = []
    for root in ("jax", "port"):
        m = jio.read_manifest(str(tmp_path / root), 0)
        for shard in m["shards"]:
            shard.pop("sha256"), shard.pop("bytes")
        manifests.append(m)
    assert manifests[0] == manifests[1]
    into_port = mt.TenantSet(_config2(mt, **CPU), capacity=8)
    ck.restore_checkpoint(into_port, str(tmp_path / "jax"), host_count=1)
    into_jax = M.TenantSet(_config2(M), capacity=8)
    jck.restore_checkpoint(into_jax, str(tmp_path / "port"), host_count=1)
    assert into_port.tenant_ids() == jts.tenant_ids() and into_jax.tenant_ids() == pts.tenant_ids()
    assert into_port.tenant_update_counts() == jts.tenant_update_counts()
    for lname, st in jts.stacked_states.items():
        for k, v in st.items():
            np.testing.assert_array_equal(into_port.stacked_states[lname][k].numpy(), np.asarray(v))
            np.testing.assert_array_equal(np.asarray(into_jax.stacked_states[lname][k]), pts.stacked_states[lname][k].numpy())


# --------------------------------------------------------------------- chaos --
def _chaos_set(n_admit=2):
    ts = mt.TenantSet(mt.MetricCollection({"mean": TinyMean(**CPU)}), capacity=4)
    for i in range(n_admit):
        ts.admit(f"t{i}")
    return ts


def test_tenancy_sites_are_registered():
    assert {"tenancy/dispatch", "tenancy/admit", "tenancy/evict"} <= set(KNOWN_SITES)


def test_dispatch_fault_leaves_no_partial_state():
    ts = _chaos_set()
    ts.update(["t0", "t1"], torch.ones((2, 4)))
    counts = dict(ts.tenant_update_counts())
    before = {t: v["mean"].clone() for t, v in ts.compute().items()}
    with chaos.plan([FaultSpec("tenancy/dispatch", nth=1, times=1)], seed=0) as p:
        with pytest.raises(ChaosError):
            ts.update(["t0", "t1"], torch.full((2, 4), 9.0))
        assert p.fired("tenancy/dispatch") == 1 and ts.tenant_update_counts() == counts
        for t, v in ts.compute().items():
            assert_bitwise(v["mean"], before[t])
        ts.update(["t0", "t1"], torch.full((2, 4), 9.0))
    assert ts.tenant_update_counts()["t0"] == counts["t0"] + 1


def test_admit_and_evict_faults_leave_no_partial_state():
    ts = _chaos_set()
    with chaos.plan([FaultSpec("tenancy/admit", nth=1, times=1)], seed=0) as p:
        with pytest.raises(ChaosError):
            ts.admit("t9")
        assert p.fired("tenancy/admit") == 1 and ts.active_count == 2 and "t9" not in ts.tenant_ids()
        ts.admit("t9")
    assert ts.active_count == 3
    ts.update(["t0", "t1"], torch.ones((2, 4)))
    before = ts.compute(["t1"])["t1"]["mean"].clone()
    with chaos.plan([FaultSpec("tenancy/evict", nth=1, times=1)], seed=0) as p:
        with pytest.raises(ChaosError):
            ts.evict("t1")
        assert "t1" in ts.tenant_ids()
        assert_bitwise(ts.compute(["t1"])["t1"]["mean"], before)
        ts.evict("t1")
    assert "t1" not in ts.tenant_ids() and ts.active_count == 2


def test_nth_dispatch_fault_is_deterministic():
    for _ in range(2):
        ts = _chaos_set()
        with chaos.plan([FaultSpec("tenancy/dispatch", nth=3, times=1)], seed=7):
            ts.update(["t0"], torch.ones((1, 4)))
            ts.update(["t0"], torch.ones((1, 4)))
            with pytest.raises(ChaosError):
                ts.update(["t0"], torch.ones((1, 4)))
        assert ts.tenant_update_counts()["t0"] == 2


# ------------------------------------------------------------- observability --
def _exercised(pkg, rows, name=None, **kw):
    ts = pkg.TenantSet(pkg.MetricCollection({"mean": (TinyMean(**kw) if pkg is mt else _jax_tiny_mean(**kw))}),
                       capacity=8, name=name)
    for tid in ("a", "b", "c"):
        ts.admit(tid)
    ts.update(["a", "b", "c"], rows(np.ones((3, 4), np.float32)))
    ts.update(["a", "b"], rows(np.ones((2, 4), np.float32)))
    ts.compute()
    ts.reset(["c"])
    ts.evict("c")
    return ts


def _jax_tiny_mean(**kw):
    from metrics_tpu.core.metric import Metric

    class JaxTinyMean(Metric):
        full_state_update = False

        def __init__(self, **kw):
            super().__init__(**kw)
            self.add_state("total", default=jnp.zeros((), jnp.float32), dist_reduce_fx="sum")
            self.add_state("count", default=jnp.zeros((), jnp.float32), dist_reduce_fx="sum")

        def update(self, values):
            self.total = self.total + jnp.sum(values)
            self.count = self.count + float(np.prod(values.shape))

        def compute(self):
            return self.total / jnp.maximum(self.count, 1.0)

    return JaxTinyMean(**kw)


@pytest.fixture(scope="module")
def jax_lifecycle():
    from metrics_tpu import observability as jobs

    with jobs.trace() as tracer:
        ts = _exercised(M, jnp.asarray, name="svc")
        counts = {k: v for k, v in tracer.counts_by_name().items() if k.startswith("tenancy/")}
        buckets = [(e.args["tenants"], e.args["bucket"]) for e in tracer.events() if e.name == "tenancy/dispatch"]
    return counts, buckets, ts.stats


def test_lifecycle_events_and_stats_match_jax(jax_lifecycle):
    want_counts, want_buckets, want_stats = jax_lifecycle
    with obs.trace() as tracer:
        ts = _exercised(mt, _rows, name="svc", **CPU)
        counts = {k: v for k, v in tracer.counts_by_name().items() if k.startswith("tenancy/")}
        events = [e for e in tracer.events() if e.name == "tenancy/dispatch"]
    assert counts == want_counts == {"tenancy/admit": 3, "tenancy/dispatch": 2, "tenancy/compute": 1,
                                     "tenancy/reset": 1, "tenancy/evict": 1}
    assert [(e.args["tenants"], e.args["bucket"]) for e in events] == want_buckets == [(3, 4), (2, 2)]
    assert all(e.args["owner"] == ts.name == "svc" for e in events)
    assert ts.stats == mt.tenancy.TenantStats(**vars(want_stats))


def test_disabled_tracer_emits_nothing():
    _exercised(mt, _rows, **CPU)
    with obs.trace() as tracer:
        counts = tracer.counts_by_name()
    assert not any(n.startswith("tenancy/") for n in counts)


def test_tenant_series_parse_strictly():
    reg = InstrumentRegistry()
    ts = _exercised(mt, _rows, name="svc", **CPU)
    reg.register_tenant_set(ts)
    families, samples = _StrictPromParser().parse(obs.to_prometheus_text(reg))
    by_name = {}
    for name, labels, value in samples:
        by_name.setdefault(name, []).append((labels, value))
    want = {
        "metrics_tpu_tenant_active": ("gauge", 2.0), "metrics_tpu_tenant_capacity": ("gauge", 8.0),
        "metrics_tpu_tenant_bucket_width": ("gauge", 2.0),
        "metrics_tpu_tenant_executables": ("gauge", float(ts.stats.compiles)),
        "metrics_tpu_tenant_admits_total": ("counter", 3.0), "metrics_tpu_tenant_evicts_total": ("counter", 1.0),
        "metrics_tpu_tenant_resets_total": ("counter", 1.0), "metrics_tpu_tenant_dispatches_total": ("counter", 2.0),
    }
    for name, (kind, value) in want.items():
        assert families[name]["type"] == kind
        (labels, got), = by_name[name]
        assert labels == {"owner": "svc"} and got == value
    updates = {labels["tenant"]: value for name, labels, value in samples if name == "metrics_tpu_tenant_updates_total"}
    assert updates == {"a": 2.0, "b": 2.0}
    del ts
    gc.collect()
    assert "metrics_tpu_tenant_active" not in obs.to_prometheus_text(reg)


# ------------------------------------------------------------------- sharding --
def test_unplaced_shard_axis_declaration_still_stacks():
    path, reason = classify_tenant_member(mt.ConfusionMatrix(num_classes=8, **CPU))
    assert path == PATH_TENANT, reason
    assert mt.ConfusionMatrix(num_classes=8, **CPU).shard_axes == {"confmat": 0}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = td.GlooWorld(WORLD, str(tmp_path_factory.mktemp("gloo")))
    yield w
    w.close()


def test_placed_sharded_member_demotes_and_stays_correct(world):
    """A placed member's group runs per tenant (the JAX engine's stable
    reason), the unplaced group keeps the stacked path, and both equal
    independent metrics on the same streams."""
    out = world.run_all(tt.sharded_tenant_set)
    for r in out:
        assert r["reason"] == "sharded state: the tenant axis would conflict with the mesh placement"
        assert r["paths"] == {"cm": PATH_EAGER, "counts": PATH_TENANT}
        assert r["eager_updates"] > 0
        for tid, (got, want) in r["results"].items():
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------- sync --
def test_stacked_sync_count_independent_of_capacity(world):
    small = world.run_all(tt.stacked_sync_counts, 16, 3)
    large = world.run_all(tt.stacked_sync_counts, 1024, 37)
    for s, l in zip(small, large):
        # one (sum, f32) bucket and one (max, f32) bucket, whatever N
        assert s["count"] == l["count"] == 2 and s["by_kind"] == l["by_kind"] == {"all_reduce": 2}
        assert l["bytes"] == s["bytes"] * (1024 // 16)


def test_stacked_sync_count_independent_of_group_count(world):
    for r in world.run_all(tt.one_group_counts):
        assert r == {"one": 1, "two": 2}


@pytest.mark.parametrize("transport", ["bf16", "int8"])
def test_stacked_sync_count_independent_of_capacity_per_transport(world, transport):
    small = world.run_all(tt.stacked_sync_counts, 16, 3, transport)
    large = world.run_all(tt.stacked_sync_counts, 1024, 37, transport)
    for s, l in zip(small, large):
        assert s["count"] == l["count"] and s["by_kind"] == l["by_kind"]
        assert transport in s["bytes_by_transport"]
        assert l["bytes_by_transport"][transport]["wire"] > s["bytes_by_transport"][transport]["wire"]


def test_template_declaration_reaches_stacked_sync(world):
    for r in world.run_all(tt.declared_transport_counts):
        bf16 = r["bytes_by_transport"]["bf16"]
        assert bf16["wire"] * 2 == bf16["logical"] and r["refusals"] == 0


def test_stacked_sync_sum_and_max_parity(world):
    scale = float(sum(range(1, WORLD + 1)))
    for r in world.run_all(tt.stacked_sync_values, 8, 5):
        for lname, st in r["base"].items():
            for name, leaf in st.items():
                expect = leaf * WORLD if name == "peak" else leaf * scale
                np.testing.assert_array_equal(r["synced"][lname][name], expect)


def test_stacked_sync_without_group_is_identity():
    ts, _ = tt.tiny_set(8, 3)
    base = ts.stacked_states
    synced = ts.sync_states(base, None)
    for lname, st in base.items():
        for name, leaf in st.items():
            assert synced[lname][name] is leaf


def test_non_elementwise_reduction_raises():
    states = {"m": {"buf": torch.zeros((4, 2))}}
    with pytest.raises(ValueError, match="non-elementwise"):
        sync_stacked_states(states, {"m": {"buf": "cat"}}, object())


def test_incremental_emission_count_independent_of_capacity(world):
    small = world.run_all(tt.incremental_emission_counts, 16, 3)
    large = world.run_all(tt.incremental_emission_counts, 1024, 37)
    for s, l in zip(small, large):
        assert s["count"] == l["count"] == 2 and s["by_kind"] == l["by_kind"]


def test_incremental_finalize_is_collective_free_and_equals_deferred(world):
    for r in world.run_all(tt.incremental_against_deferred, 8, 5):
        assert r["finalize_collectives"] == 0
        for lname, st in r["want"].items():
            for name, leaf in st.items():
                np.testing.assert_array_equal(r["got"][lname][name], leaf)


# ------------------------------------------------------------ B1's vmap rule --
def _b1_inputs(seed, b=5, n=40, c=6, labels=True):
    rng = np.random.default_rng(seed)
    preds = torch.from_numpy(rng.uniform(0, 1, (b, n, c)).astype(np.float32))
    preds[0, ::7, 0] = float("nan")
    target = (torch.from_numpy(rng.integers(-1, c + 1, (b, n))) if labels
              else torch.from_numpy(rng.uniform(0, 1, (b, n, c)) < 0.5))
    return preds, target


@pytest.mark.parametrize("labels", [True, False])
def test_vmapped_binned_counts_equals_a_loop(labels):
    preds, target = _b1_inputs(3, labels=labels)
    grid = B1.sort_thresholds(torch.tensor([0.5, 0.0, 1.0, 0.25, 0.75, 0.25, 0.9]))
    loop = torch.stack([torch.stack(B1.binned_counts(p, y, grid)) for p, y in zip(preds, target)])
    vmapped = torch.func.vmap(lambda p, y: torch.stack(B1.binned_counts(p, y, grid)))(preds, target)
    plain = torch.func.vmap(lambda p, y: torch.stack(B1.binned_counts(p, y, grid, plain=True)))(preds, target)
    assert_bitwise(vmapped, loop)
    assert_bitwise(plain, loop)
    assert_bitwise(B1.binned_counts_batched(preds, target, grid), loop)
    assert_bitwise(B1.binned_counts_batched(preds, target, grid, plain=True), loop)


def test_binned_counts_under_two_tenant_axes_and_broadcast_targets():
    preds, target = _b1_inputs(4, b=6)
    grid = B1.sort_thresholds(torch.linspace(0, 1, 11))
    loop = torch.stack([torch.stack(B1.binned_counts(p, y, grid)) for p, y in zip(preds, target)])
    nested = torch.func.vmap(torch.func.vmap(lambda p, y: torch.stack(B1.binned_counts(p, y, grid))))(
        preds.reshape(2, 3, *preds.shape[1:]), target.reshape(2, 3, -1))
    assert_bitwise(nested.reshape(loop.shape), loop)
    one = target[0]
    bcast = torch.func.vmap(lambda p: torch.stack(B1.binned_counts(p, one, grid)))(preds)
    assert_bitwise(bcast, torch.stack([torch.stack(B1.binned_counts(p, one, grid)) for p in preds]))
    with pytest.raises(ValueError, match="one threshold grid"):
        torch.func.vmap(lambda p, v: torch.stack(B1.binned_counts(p, one, B1.SortedThresholds(v, grid.order))))(
            preds, grid.values.expand(6, -1))


def test_binned_counts_operator_has_fake_shapes():
    preds, target = _b1_inputs(5, b=2)
    grid = B1.sort_thresholds(torch.linspace(0, 1, 9))
    first_p, first_t = preds[0], target[0]
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fp, ft = mode.from_tensor(first_p), mode.from_tensor(first_t)
        fv, fo = mode.from_tensor(grid.values), mode.from_tensor(grid.order)
        assert tuple(B1._counts_op(fp, ft, fv, fo).shape) == (3, 6, 9)
        fbp, fbt = mode.from_tensor(preds), mode.from_tensor(target)
        assert tuple(B1._batched_op(fbp, fbt, fv, fo).shape) == (2, 3, 6, 9)

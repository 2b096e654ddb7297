"""The port's incremental sync and its captured steps against the JAX package's.

Mirrors ``tests/core/test_incremental_sync.py`` case for case (its sharded
cases since the port's sharded state). The port's side runs in one gloo
world of 4 CPU ranks for the module (``tests/helpers/torch_dist.py``), each
rank on its own seeded batches; the JAX side runs the same batches on 4
of the 8 CPU devices through ``shard_map``, the module's references in one
jitted function (the ``jax_refs`` fixture). Stated tolerances:

- An incremental streak finalizes bit for bit to the port's deferred
  ``sync_state`` of the final state, at every cadence (K = 1, 2, 4, 5, 7 over
  5 steps: every step, tails of 1, one emission, none), and both equal the
  JAX package's bit for bit. The float leaves add multiples of 1/8, whose
  sums are exact in any order (gloo's ring and XLA's all-reduce add in
  different orders).
- Collective counts per step and at finalize equal the JAX package's trace
  counts; plans, modes and the engines' ``"incremental"`` partition section
  equal the JAX package's key for key.
- Computed values (``sync_compute_incremental``, the captured synced
  computes) within 1e-6 of the JAX package's; the port's captured and eager
  paths agree bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import metrics_tpu as mt_jax
import metrics_tpu_torch as mt_torch
from __graft_entry__ import _make_collection as jax_collection
from metrics_tpu.core.engine import classify_incremental_member as jax_classify
from metrics_tpu.parallel import sync as jax_sync
from metrics_tpu_torch.core import engine as port_engine
from metrics_tpu_torch.parallel import sync as port_sync
from tests.helpers import torch_dist as td
from tests.helpers import torch_shard as ts
from tests.helpers.torch_port import assert_bitwise, assert_close, one_torch_thread  # noqa: F401  (the module fixture)

try:
    from jax import shard_map  # jax >= 0.8
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

pytestmark = [pytest.mark.usefixtures("one_torch_thread"), pytest.mark.filterwarnings("ignore")]

WORLD = 4
STEPS = 5
KS = [1, 2, 4, 5, 7]
INCR = {k: "incremental" for k in td.INCR_REDUCTIONS}
MIXED = {"hits": "incremental", "total": "incremental"}


@pytest.fixture(autouse=True)
def _mode_defaults():
    """Every test starts and ends on the factory mode and cadence defaults."""
    for mod in (port_sync, jax_sync):
        mod.set_sync_mode(None)
        mod.set_sync_cadence(None)
        mod.set_sync_transport(None)
    yield
    for mod in (port_sync, jax_sync):
        mod.set_sync_mode(None)
        mod.set_sync_cadence(None)
        mod.set_sync_transport(None)


def _batches(seed=0, steps=STEPS):
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, 7, (WORLD, steps, 16)).astype(np.int32)
    ts = (rng.integers(-16, 17, (WORLD, steps, 8)) / 8).astype(np.float32)
    return xs, ts


XS, TS = _batches()
ACC_PREDS = np.random.default_rng(7).standard_normal((WORLD, 4, 16, td.C)).astype(np.float32)
ACC_TARGET = np.random.default_rng(8).integers(0, td.C, (WORLD, 4, 16)).astype(np.int64)


# --------------------------------------------------------------------------- #
# the JAX references
# --------------------------------------------------------------------------- #
def _jax_state():
    return {"hits": jnp.arange(16, dtype=jnp.int32), "n": jnp.asarray(0, jnp.int32),
            "total": jnp.zeros((8,), jnp.float32), "peak": jnp.asarray(-jnp.inf, jnp.float32)}


def _jax_step(state, x, t):
    return {"hits": state["hits"] + x, "n": state["n"] + jnp.asarray(1, jnp.int32), "total": state["total"] + t,
            "peak": jnp.maximum(state["peak"], jnp.max(x.astype(jnp.float32)))}


def _smap(fn, n_in):
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    kwargs = dict(mesh=mesh, in_specs=(P("data"),) * n_in, out_specs=P("data"))
    try:
        return shard_map(fn, check_vma=False, **kwargs)
    except TypeError:  # pragma: no cover - pre-0.8 jax spells the flag check_rep
        return shard_map(fn, check_rep=False, **kwargs)


@pytest.fixture(scope="module")
def jax_refs():
    reds = td.INCR_REDUCTIONS
    acc = mt_jax.Accuracy(num_classes=td.C, average="micro")
    for name in acc._defaults:
        acc._sync_modes[name] = "incremental"

    def body(xs, ts, preds, target):
        out = {}
        state = _jax_state()
        for i in range(STEPS):
            state = _jax_step(state, xs[0, i], ts[0, i])
        out["deferred"] = jax_sync.sync_state(state, reds, "data")
        for k, modes in [(k, INCR) for k in KS] + [("mixed", MIXED)]:
            carry = jax_sync.init_incremental(_jax_state(), reds, modes=modes, sync_every=1 if k == "mixed" else k)
            for i in range(STEPS):
                carry = jax_sync.advance_incremental(carry, _jax_step(carry.state, xs[0, i], ts[0, i]), reds, "data",
                                                     modes=modes)
            out[f"incr_{k}"] = jax_sync.finalize_incremental_state(carry, reds, "data", modes=modes)
        carry = acc.init_incremental(acc.init_state(), sync_every=2)
        for i in range(preds.shape[1]):
            carry = acc.update_state_incremental(carry, preds[0, i], target[0, i], axis_name="data")
        out["acc"] = acc.finalize_incremental(carry, "data")
        out["acc_value"] = acc.sync_compute_incremental(carry, "data")
        return jax.tree_util.tree_map(lambda v: jnp.expand_dims(v, 0), out)

    got = jax.jit(_smap(body, 4))(XS, TS, ACC_PREDS, ACC_TARGET)
    return jax.tree_util.tree_map(lambda v: np.asarray(v[0]), got)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = td.GlooWorld(WORLD, str(tmp_path_factory.mktemp("gloo")))
    yield w
    w.close()


def _streak(world, k, modes=INCR, xs=XS, ts=TS, **kw):
    reports = world.run(td.incremental_streak, [(xs[r], ts[r], k, modes) + tuple(kw.values()) for r in range(WORLD)])
    for report in reports[1:] if not kw.get("no_group") else ():  # synced: every rank holds the same
        for key in report["out"]:
            assert_bitwise(report["out"][key], reports[0]["out"][key], msg=f"ranks disagree on {key}")
    return reports[0]


@pytest.fixture(scope="module")
def deferred(world):
    reports = world.run(td.deferred_streak, [(XS[r], TS[r]) for r in range(WORLD)])
    return reports[0]


def _assert_tree_bitwise(got, want, msg=""):
    assert set(got) == set(want), msg
    for key in want:
        assert_bitwise(got[key], want[key], msg=f"{msg}{key}")


# ----------------------------------------------------------------- parity ----
class TestBitwiseParity:
    @pytest.mark.parametrize("k", KS)
    def test_streak_matches_deferred(self, world, deferred, jax_refs, k):
        """Every cadence class: K = 1 (each step), 2 (a tail of 1), 4 (one
        emission, a tail of 1), 5 (one emission, no tail), 7 (never emits:
        finalize is the deferred path)."""
        got = _streak(world, k)
        _assert_tree_bitwise(got["out"], deferred["out"], "incremental vs deferred: ")
        _assert_tree_bitwise(got["out"], jax_refs["deferred"], "port vs JAX deferred: ")
        _assert_tree_bitwise(got["out"], jax_refs[f"incr_{k}"], "port vs JAX incremental: ")

    def test_mixed_modes_match_deferred(self, world, deferred, jax_refs):
        got = _streak(world, 1, MIXED)
        _assert_tree_bitwise(got["out"], deferred["out"])
        _assert_tree_bitwise(got["out"], jax_refs["incr_mixed"])

    def test_metric_protocol_matches_sync_states(self, world, jax_refs):
        """Accuracy with every state incremental finalizes to the bytes of its
        deferred ``sync_states`` and of the JAX package's; its
        ``sync_compute_incremental`` to the same value."""
        reports = world.run(td.metric_incremental, [(ACC_PREDS[r], ACC_TARGET[r], 2) for r in range(WORLD)])
        for report in reports:
            _assert_tree_bitwise(report["incremental"], report["deferred"])
            _assert_tree_bitwise(report["incremental"], jax_refs["acc"])
            assert_bitwise(report["incremental_value"], report["deferred_value"])
            assert_close(report["incremental_value"], jax_refs["acc_value"], rtol=1e-6, atol=0)


# ------------------------------------------------------- collective counts ---
def _jax_counts(sync_every, steps, modes=INCR):
    """The JAX package's per-step and finalize trace counts of a streak."""
    reds = td.INCR_REDUCTIONS
    per_step, final = [], []

    def probe(state0):
        carry = jax_sync.init_incremental(dict(state0), reds, modes=modes, sync_every=sync_every)
        for _ in range(steps):
            state = _jax_step(carry.state, jnp.zeros((16,), jnp.int32), jnp.zeros((8,), jnp.float32))
            with jax_sync.count_collectives() as box:
                carry = jax_sync.advance_incremental(carry, state, reds, "data", modes=modes)
            per_step.append(box["count"])
        with jax_sync.count_collectives() as box:
            jax_sync.finalize_incremental_state(carry, reds, "data", modes=modes)
        final.append(box["count"])
        return jnp.zeros(())

    jax.make_jaxpr(probe, axis_env=[("data", WORLD)])(_jax_state())
    return per_step, final[0]


class TestCollectiveCounts:
    @pytest.mark.parametrize("k,steps,modes,want", [
        (1, 4, INCR, ([3, 3, 3, 3], 0)),  # one fold bucket, a float sum and a max: a free finalize
        (4, 6, INCR, ([0, 0, 0, 3, 0, 0], 3)),  # the tail: one fold delta, the two replace buckets again
        (9, 3, INCR, ([0, 0, 0], 3)),  # never emits: the deferred sync's three buckets
        (1, 2, {"hits": "incremental"}, ([1, 1], 3)),  # deferred leaves cost nothing in the streak
    ])
    def test_counts_equal_the_jax_packages(self, world, k, steps, modes, want):
        xs, ts = _batches(seed=11, steps=steps)
        got = _streak(world, k, modes, xs, ts)
        assert (got["per_step"], got["final"]) == want == _jax_counts(k, steps, modes)

    def test_never_emitting_carry_finalizes_like_deferred(self, world, deferred):
        got = _streak(world, 9)
        assert got["final"] == deferred["count"]
        _assert_tree_bitwise(got["out"], deferred["out"])

    def test_no_group_advance_never_emits(self, world):
        """``group=None`` tracks the state only: no collective, no emission,
        and finalize returns the live state."""
        got = _streak(world, 1, INCR, XS, TS, no_group=True)
        assert sum(got["per_step"]) == 0 and got["final"] == 0
        assert {m[2] for m in got["marks"]} == {0}
        _assert_tree_bitwise(got["out"], got["state"])


# --------------------------------------------------- carry / signature bounds --
class TestCarryStability:
    def test_carry_flattens_through_the_engines_tree(self):
        carry = port_sync.init_incremental(td.incr_state(), td.INCR_REDUCTIONS, modes=INCR, sync_every=3)
        leaves, spec = port_engine.tree_flatten(carry)
        rebuilt = port_engine.tree_unflatten(leaves, spec)
        assert isinstance(rebuilt, port_sync.IncrementalCarry)
        assert (rebuilt.sync_every, rebuilt.pending, rebuilt.emissions) == (3, 0, 0) and not rebuilt.synced
        assert len(leaves) == 4 + 4 + 2  # the state, an accumulator per leaf, a delta base per fold leaf
        assert all(a is b for a, b in zip(port_engine.tree_leaves(rebuilt), leaves))

    def test_bookkeeping_is_bounded_by_the_cadence(self, world):
        """``pending`` cycles 0..K-1 and ``emissions`` saturates at 1 without
        quantized transports: a 20-step streak at K = 3 shows the same
        bounded set of carry bookkeeping as the JAX package's static aux."""
        xs, ts = _batches(seed=12, steps=20)
        got = {tuple(m) for m in _streak(world, 3, INCR, xs, ts)["marks"]}
        seen = set()

        def streak(state0):
            carry = jax_sync.init_incremental(dict(state0), td.INCR_REDUCTIONS, modes=INCR, sync_every=3)
            for _ in range(20):
                state = _jax_step(carry.state, jnp.zeros((16,), jnp.int32), jnp.zeros((8,), jnp.float32))
                carry = jax_sync.advance_incremental(carry, state, td.INCR_REDUCTIONS, "data", modes=INCR)
                seen.add((carry.sync_every, carry.pending, carry.emissions, carry.track_emissions))
            return jnp.zeros(())

        jax.make_jaxpr(streak, axis_env=[("data", WORLD)])(_jax_state())
        assert got == seen
        assert {p for (_, p, _, _) in got} == {0, 1, 2} and {e for (_, _, e, _) in got} == {0, 1}

    def test_no_group_pending_saturates(self):
        carry = port_sync.init_incremental(td.incr_state(), td.INCR_REDUCTIONS, modes=INCR, sync_every=2)
        for _ in range(10):
            carry = port_sync.advance_incremental(carry, td.incr_state(), td.INCR_REDUCTIONS, None, modes=INCR)
        assert carry.pending == 2  # saturated at K, not 10


# ------------------------------------------------------------ mode plumbing --
def _plans(modes=None, **kw):
    port = port_sync.incremental_plan(td.incr_state(), td.INCR_REDUCTIONS, modes=modes, **kw)
    return port, jax_sync.incremental_plan(_jax_state(), td.INCR_REDUCTIONS, modes=modes, **kw)


class TestModeSurface:
    def test_plan_routing_and_codecs(self):
        port, ref = _plans(INCR)
        assert port == ref
        assert port["hits"]["codec"] == port["n"]["codec"] == "fold"
        assert port["total"]["codec"] == port["peak"]["codec"] == "replace"
        assert all(e["eligible"] and e["mode"] == "incremental" for e in port.values())

    def test_default_mode_is_deferred(self):
        assert mt_torch.sync_mode_default() == mt_jax.sync_mode_default() == "deferred"
        port, ref = _plans()
        assert port == ref and all(e["mode"] == "deferred" and e["eligible"] for e in port.values())

    def test_global_switch_engages_all_eligible(self):
        mt_torch.set_sync_mode("incremental")
        mt_jax.set_sync_mode("incremental")
        port, ref = _plans()
        assert port == ref and all(e["mode"] == "incremental" for e in port.values())

    def test_per_state_declaration_beats_global(self):
        mt_torch.set_sync_mode("incremental")
        mt_jax.set_sync_mode("incremental")
        port, ref = _plans({"hits": "deferred"})
        assert port == ref
        assert port["hits"]["mode"] == "deferred" and port["total"]["mode"] == "incremental"

    def test_env_var_is_the_weakest_rung(self, monkeypatch):
        monkeypatch.setenv("METRICS_TPU_SYNC_MODE", "incremental")
        assert mt_torch.sync_mode_default() == "incremental"
        mt_torch.set_sync_mode("deferred")  # the process switch beats the environment
        assert mt_torch.sync_mode_default() == "deferred"
        mt_torch.set_sync_mode(None)  # back to the environment
        assert mt_torch.sync_mode_default() == "incremental"
        monkeypatch.setenv("METRICS_TPU_SYNC_MODE", "sometimes")
        assert mt_torch.sync_mode_default() == "deferred"

    def test_unknown_modes_raise(self):
        with pytest.raises(ValueError, match="unknown sync mode"):
            mt_torch.set_sync_mode("streaming")
        with pytest.raises(ValueError, match="unknown sync mode"):
            port_sync.incremental_plan(td.incr_state(), td.INCR_REDUCTIONS, modes={"hits": "lazy"})

    def test_add_state_sync_mode_kwarg(self):
        class Declared(mt_torch.Metric):
            def __init__(self, mode="incremental", **kw):
                super().__init__(device="cpu", **kw)
                self.add_state("c", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum", sync_mode=mode)

            def update(self):
                self.c = self.c + 1

            def compute(self):
                return self.c

        m = Declared()
        assert m.sync_modes == {"c": "incremental"}
        assert m.incremental_plan()["c"]["mode"] == "incremental"
        with pytest.raises(ValueError, match="sync_mode"):
            Declared("sometimes")

    def test_cadence_ladder(self, monkeypatch):
        assert mt_torch.sync_cadence_default() == 1
        monkeypatch.setenv("METRICS_TPU_SYNC_EVERY", "4")
        assert mt_torch.sync_cadence_default() == 4
        mt_torch.set_sync_cadence(2)
        assert mt_torch.sync_cadence_default() == 2
        mt_torch.set_sync_cadence(None)
        assert mt_torch.sync_cadence_default() == 4
        monkeypatch.setenv("METRICS_TPU_SYNC_EVERY", "four")
        assert mt_torch.sync_cadence_default() == 1
        with pytest.raises(ValueError):
            mt_torch.set_sync_cadence(0)
        with pytest.raises(ValueError):
            port_sync.init_incremental(td.incr_state(), td.INCR_REDUCTIONS, modes=INCR, sync_every=0)


# ----------------------------------------------- ineligible leaves / residue --
class TestResidueRouting:
    def test_cat_list_callable_and_sharded_stay_deferred(self):
        custom = lambda xs: xs  # noqa: E731
        reds = {"rows": "cat", "chunks": "cat", "custom": custom, "tiles": "sum"}
        modes = {k: "incremental" for k in reds}
        port = port_sync.incremental_plan(
            {"rows": torch.zeros(4, 2), "chunks": [torch.zeros(2)], "custom": torch.zeros(()), "tiles": torch.zeros(8, 3)},
            reds, modes=modes, shard_axes={"tiles": 0})
        ref = jax_sync.incremental_plan(
            {"rows": jnp.zeros((4, 2)), "chunks": [jnp.zeros((2,))], "custom": jnp.zeros(()), "tiles": jnp.zeros((8, 3))},
            reds, modes=modes, shard_axes={"tiles": 0})
        assert port == ref
        assert all(e["mode"] == "deferred" and not e["eligible"] for e in port.values())
        assert "not mergeable-elementwise" in port["rows"]["reason"]
        assert "per-device layout" in port["chunks"]["reason"]
        assert "resharded at finalize" in port["tiles"]["reason"]

    def test_sharded_leaf_reshards_at_finalize_only(self, world):
        """A shard_axis leaf under incremental mode is residue: the step
        emits only the replicated fold bucket, and finalize reshards the
        sharded leaf as the deferred sync does, bit for bit (float tiles in
        integer steps, exact in any order)."""
        tiles = [np.arange(WORLD * 3, dtype=np.float32).reshape(WORLD, 3) * (r + 1) for r in range(WORLD)]
        hits = [np.arange(4, dtype=np.int32) * (r + 1) for r in range(WORLD)]
        reports = world.run(ts.sharded_incremental, list(zip(tiles, hits)))
        want_tiles = np.concatenate([2.0 * t for t in tiles])
        want_hits = np.sum([h + 1 for h in hits], axis=0, dtype=np.int32)
        for report in reports:
            for got in (report["finalized"], report["deferred"]):
                assert_bitwise(got["tiles"], want_tiles)
                assert_bitwise(got["hits"], want_hits)

    def test_sharded_emission_excludes_reshard_buckets(self, world):
        zeros = (np.zeros((WORLD, 3), np.float32), np.zeros(4, np.int32))
        for report in world.run(ts.sharded_incremental, [zeros] * WORLD):
            assert report["acc"] == ["hits"]  # the sharded leaf is residue
            assert report["advance"]["count"] == 1  # the int-sum fold bucket only

    def test_catbuffer_and_sketch_routing(self):
        from metrics_tpu_torch import sketches

        state = {"buf": mt_torch.CatBuffer.empty(8), "q": sketches.QuantileSketch(device="cpu")}
        plan = port_sync.incremental_plan(state, {"buf": "cat", "q": "sketch"}, modes={"buf": "incremental", "q": "incremental"})
        assert plan["buf"]["mode"] == "deferred" and "per-device layout" in plan["buf"]["reason"]
        assert plan["q"] == {"mode": "incremental", "codec": "sketch", "eligible": True, "reason": ""}


# --------------------------------------------------- quantized composition ---
def _quant_plans(tol, scale):
    state, reds, tr = {"total": np.zeros(256, np.float32)}, {"total": "sum"}, {"total": "bf16"}
    port = port_sync.transport_plan({"total": torch.zeros(256)}, reds, WORLD, transports=tr, tolerances={"total": tol},
                                    error_scale=scale)
    ref = jax_sync.transport_plan({"total": jax.ShapeDtypeStruct((256,), jnp.float32)}, reds, WORLD, transports=tr,
                                  tolerances={"total": tol}, error_scale=scale)
    assert port == ref
    return port


class TestQuantizedComposition:
    def test_cadence_compounds_the_error_bound(self):
        tol = port_sync.transport_error_bound("bf16", WORLD) * 8.0
        single, fourth = _quant_plans(tol, 1.0), _quant_plans(tol, 4.0)
        assert single[0]["transport"] == fourth[0]["transport"] == "bf16"
        assert fourth[0]["bound"] == pytest.approx(single[0]["bound"] * 4.0)

    def test_refusal_reports_effective_emission_count(self):
        tol = port_sync.transport_error_bound("bf16", WORLD) * 2.0
        assert _quant_plans(tol, 1.0)[0]["refusal"] is None
        refused = _quant_plans(tol, 4.0)
        assert refused[0]["transport"] == "exact"
        assert refused[0]["refusal"]["reason"] == "error_budget" and refused[0]["refusal"]["emissions"] == 4

    def test_quantized_emissions_track_real_ordinal(self, world, deferred):
        """A quantized covered leaf makes the carry count its true emission
        ordinal, so each emission's gate compounds; exact carries saturate."""
        xs, ts = _batches(seed=13, steps=3)
        modes = {"hits": "incremental"}
        quant = _streak(world, 1, modes, xs, ts, no_group=False, transports={"hits": "sparse_count"})
        exact = _streak(world, 1, modes, xs, ts)
        assert [m[2] for m in quant["marks"]] == [1, 2, 3]
        assert [m[2] for m in exact["marks"]] == [1, 1, 1]
        _assert_tree_bitwise(quant["out"], exact["out"])  # sparse_count is lossless


# -------------------------------------------------- engine / partition view --
def _config2(pkg, **kw):
    return pkg.MetricCollection({
        "acc": pkg.Accuracy(num_classes=5, average="micro", **kw),
        "prec": pkg.Precision(num_classes=5, average="macro", **kw),
        "rec": pkg.Recall(num_classes=5, average="macro", **kw),
    })


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((32, 5)).astype(np.float32), rng.integers(0, 5, 32)


class TestEngineIntegration:
    def test_classifier_follows_the_resolved_mode(self):
        port, ref = mt_torch.Accuracy(num_classes=5, device="cpu"), mt_jax.Accuracy(num_classes=5)
        assert port_engine.classify_incremental_member(port) == jax_classify(ref)
        assert port_engine.classify_incremental_member(port)[0] == "deferred"
        mt_torch.set_sync_mode("incremental")
        mt_jax.set_sync_mode("incremental")
        path, reason = port_engine.classify_incremental_member(port)
        assert (path, reason) == jax_classify(ref) and path == "incremental" and "emission" in reason

    @pytest.mark.parametrize("mode", [None, "incremental"])
    def test_partition_view_incremental_section_equals_the_jax_engines(self, mode):
        mt_torch.set_sync_mode(mode)
        mt_jax.set_sync_mode(mode)
        preds, target = _inputs(0)
        port, ref = _config2(mt_torch, device="cpu"), _config2(mt_jax)
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        view = port.engine_stats()["partition"]
        assert view["incremental"] == ref._dispatcher.partition_view()["incremental"]
        assert set(view["incremental"]) == set(port._metrics)
        assert {info["path"] for info in view["incremental"].values()} == {mode or "deferred"}
        single = mt_torch.Accuracy(num_classes=5, device="cpu").engine_stats()["partition"]["incremental"]
        assert single == mt_jax.Accuracy(num_classes=5).engine_stats()["partition"]["incremental"]

    def test_mode_flip_rekeys_partition_exactly_once(self):
        coll = _config2(mt_torch, device="cpu")
        preds, target = map(torch.from_numpy, _inputs(1))
        for _ in range(4):
            coll.update(preds, target)
        assert coll._dispatcher.stats.builds == 1
        mt_torch.set_sync_mode("incremental")
        coll.update(preds, target)
        assert coll._dispatcher.stats.repartitions == 1
        assert all(info["path"] == "incremental" for info in coll.engine_stats()["partition"]["incremental"].values())
        for _ in range(3):
            coll.update(preds, target)
        assert coll._dispatcher.stats.repartitions == 1

    def test_default_deferred_path_is_unchanged(self, world):
        """At the default mode nothing is covered: the carry's finalize is the
        very ``sync_states`` of the same state, collective for collective."""
        preds, target = _inputs(2)
        for report in world.run_all(td.default_modes_sync, (preds, target.astype(np.int64))):
            assert report["covered"] == []
            _assert_tree_bitwise(report["finalized"], report["deferred"])
            assert report["fin"]["by_kind"] == report["box"]["by_kind"] and report["box"]["count"] == 1

    def test_collection_carry_protocol_round_trips(self):
        """Without a group the carries are deferred state holders: the
        finalize is the updated state, and the values the JAX package's."""
        coll, ref = _config2(mt_torch, device="cpu"), _config2(mt_jax)
        preds, target = _inputs(5)
        states = coll.init_state()
        carries = coll.init_incremental(states, sync_every=2)
        assert set(carries) == {g[0] for g in coll._groups}
        out = coll.finalize_incremental(coll.update_state_incremental(carries, torch.from_numpy(preds), torch.from_numpy(target)))
        want = {g[0]: coll._metrics[g[0]].update_state(states[g[0]], torch.from_numpy(preds), torch.from_numpy(target))
                for g in coll._groups}
        for leader in want:
            _assert_tree_bitwise(out[leader], want[leader])
        vals = coll.sync_compute_incremental(
            coll.update_state_incremental(coll.init_incremental(states), torch.from_numpy(preds), torch.from_numpy(target)))
        ref_vals = ref.sync_compute_incremental(
            ref.update_state_incremental(ref.init_incremental(ref.init_state()), jnp.asarray(preds), jnp.asarray(target)))
        for name in ref_vals:
            assert_close(vals[name], ref_vals[name], rtol=1e-6, atol=0, msg=name)


# ------------------------------------------- collectives inside captured steps --
def _rank_batches(seed, n=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(WORLD):
        batches = []
        for _ in range(n):
            logits = rng.normal(size=(16, td.C)).astype(np.float32)
            probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
            batches.append((probs, rng.integers(0, td.C, 16).astype(np.int64)))
        out.append(batches)
    return out


@pytest.fixture(scope="module")
def synced_computes(world):
    batches = _rank_batches(21)
    return batches, {t: world.run(td.captured_synced_compute, [(b, t) for b in batches]) for t in (None, "sparse_count")}


def test_captured_synced_compute_equals_eager_and_the_oracle(synced_computes):
    """Three synced computes at the engine defaults: eager, probed and
    captured, replayed (the replay runs the captured body, as a graph would):
    bitwise equal to each other and to one process fed every rank's batches;
    each ran one ``all_reduce`` per (reduction, dtype) bucket of each compute
    group, counted again at the replay."""
    batches, runs = synced_computes
    oracle = td._config2_and_binned()
    for b in (b for rank in batches for b in rank):
        oracle.update(*td.to_torch(b))
    want = td.to_numpy(oracle.compute())
    for report in runs[None]:
        assert report["stats"]["calls"] == (1, 1, 1)
        assert not report["fallback_reasons"] and set(report["paths"].values()) == {"fused"}
        for result in report["results"]:
            for key in want:
                assert_bitwise(result[key], want[key], msg=key)
        assert [b["by_kind"] for b in report["boxes"]] == [{"all_reduce": 3}] * 3


def test_engine_stats_collective_fields_equal_the_jax_trace(synced_computes):
    """The compute engine's collective fields, filled at the probe, against
    the JAX package's count of the same ``sync_compute_state`` traced in a
    ``shard_map`` (the JAX engine fills its fields at that trace; its facade
    runs a synced compute eagerly, so its own fields stay empty, as the port's
    unsynced ones do)."""
    _, runs = synced_computes
    jax_coll = jax_collection(td.C)
    jax_coll.add_metrics({"binned": mt_jax.BinnedAveragePrecision(num_classes=td.C, thresholds=21)})
    states = jax_coll.update_state(jax_coll.init_state(), jnp.asarray(_inputs(4)[0]), jnp.asarray(_inputs(4)[1]))
    specs = jax.tree_util.tree_map(lambda _: P(), states)
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    kw = dict(mesh=mesh, in_specs=(specs,), out_specs=P())
    try:
        f = shard_map(lambda st: jax_coll.sync_compute_state(st, "data"), check_vma=False, **kw)
    except TypeError:  # pragma: no cover
        f = shard_map(lambda st: jax_coll.sync_compute_state(st, "data"), check_rep=False, **kw)
    with jax_sync.count_collectives() as box:
        jax.make_jaxpr(f)(states)
    want = {}
    for kind, n in box["by_kind"].items():
        want["all_reduce" if kind in ("psum", "pmean", "pmax", "pmin") else kind] = n
    for report in runs[None]:
        stats = report["stats"]
        assert stats["collective_counts"] == want
        assert stats["collective_bytes_by_transport"] == {k: dict(v) for k, v in box["bytes_by_transport"].items()}
        assert stats["transport_refusals"] == len(box["refusals"]) == 0
    unsynced = _config2(mt_torch, device="cpu")
    preds, target = map(torch.from_numpy, _inputs(3))
    for _ in range(3):
        unsynced.update(preds, target)
        for m in unsynced.values():
            m._computed = None
        unsynced.compute()
    stats = unsynced.engine_stats()["compute"]
    assert (stats.collective_counts, stats.collective_bytes, stats.transport_refusals) == ({}, {}, 0)


def test_sparse_count_sync_is_refused_by_the_probe(synced_computes):
    """sparse_count reads its nonzero count back to the host: the probe
    refuses it before any collective, the groups of int32 counts move to
    eager with the reason (the binned AP's float sums take no sparse_count
    and stay captured), and the results stay those of the exact sync
    (lossless)."""
    _, runs = synced_computes
    for exact, report in zip(runs[None], runs["sparse_count"]):
        assert report["paths"] == {"acc": "eager", "f1": "eager", "precision": "eager", "recall": "eager",
                                   "binned": "fused"}
        assert all("sparse_count" in r and "host" in r for k, r in report["reasons"].items() if k == "acc")
        assert any("sparse_count" in r for r in report["fallback_reasons"].values())
        for got in report["results"]:
            for key, value in exact["results"][0].items():
                assert_bitwise(got[key], value, msg=key)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_captured_incremental_step_matches_eager_and_deferred(world, k):
    """``CompiledIncrementalStep`` over config2 plus a binned AP, every
    state incremental: its finalize bitwise equal to the eager protocol's and
    to the deferred sync of the final states; one emission every K steps;
    the emitting and the quiet step each captured once."""
    steps = 6
    batches = _rank_batches(30 + k, n=steps)
    for report in world.run(td.captured_incremental, [(b, k) for b in batches]):
        assert report["broken"] is None
        for leader, states in report["deferred"].items():
            _assert_tree_bitwise(report["captured"][leader], states, f"{leader}.")
            _assert_tree_bitwise(report["eager"][leader], states, f"{leader}.")
        assert report["emitting"] == steps // k
        # a tail: one delta per fold (int32) bucket of the two groups, the binned AP's float sums again
        assert report["final"] == (0 if steps % k == 0 else 3)
        assert sum(1 for c in report["counts"] if c) == steps // k  # replays count their collectives
        # (eager calls, captures, replays): the quiet and the emitting signature each
        assert report["calls"] == {1: (1, 1, 4), 2: (2, 2, 2), 4: (2, 1, 3)}[k]

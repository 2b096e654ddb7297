"""The compiled engines of the port at the collection level, against the JAX
package's: the fused group update and compute, the partition-aware
dispatcher, migrations, member detach/realias and the switches.

Ported from ``tests/core/test_fused_collection_update.py``,
``tests/core/test_partitioned_dispatch.py`` and the collection cases of
``tests/core/test_compiled_update_engine.py`` and
``tests/core/test_compiled_compute_engine.py``. The same seeded numpy inputs
go through ``metrics_tpu`` (engines on, CPU) and ``metrics_tpu_torch``
(``device="cpu"``, engines on): int32 states bitwise, float results bitwise
against the port's eager run and within rtol 1e-6 / atol 1e-7 of JAX, the
``EngineStats`` counters and the partition views equal member for member.
"""
import pickle
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt_jax
import metrics_tpu_torch as mt_torch
from metrics_tpu_torch.core import engine as engine_mod
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from tests.helpers.torch_port import BodyGraph, assert_bitwise, assert_close, use_card_replay_path

C = 5
COUNTERS = ("eager_calls", "cache_misses", "cache_hits", "donated_calls", "bucketed_calls")


@pytest.fixture(autouse=True)
def _engines_on():
    for pkg in (mt_jax, mt_torch):
        pkg.set_compiled_update(True)
        pkg.set_compiled_compute(True)
        pkg.set_fused_update(True)
    yield
    for pkg in (mt_jax, mt_torch):
        pkg.set_compiled_update(None)
        pkg.set_compiled_compute(None)
        pkg.set_fused_update(None)


def _data(n=64, c=C, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, c)).astype(np.float32), rng.integers(0, c, n)


def _conv(pkg, preds, target):
    if pkg is mt_jax:
        return jnp.asarray(preds), jnp.asarray(target)
    return torch.from_numpy(preds.copy()), torch.from_numpy(np.asarray(target).copy())


def _kw(pkg, **kw):
    return dict(kw, device="cpu") if pkg is mt_torch else kw


def _counters(stats) -> dict:
    return {k: getattr(stats, k) for k in COUNTERS}


def _config2(pkg, binned=False, member_kw=None, **kw):
    """The main path's collection: Accuracy (micro), F1/Precision/Recall
    (macro); with ``binned`` also BinnedAveragePrecision."""
    mk = _kw(pkg, **(member_kw or {}))
    members = {
        "acc": pkg.Accuracy(num_classes=C, average="micro", **mk),
        "f1": pkg.F1Score(num_classes=C, average="macro", **mk),
        "precision": pkg.Precision(num_classes=C, average="macro", **mk),
        "recall": pkg.Recall(num_classes=C, average="macro", **mk),
    }
    if binned:
        members["binned"] = pkg.BinnedAveragePrecision(num_classes=C, **mk)
    return pkg.MetricCollection(members, **kw)


def _eager_twin(pkg, binned=False, **kw):
    coll = _config2(pkg, binned, member_kw={"compiled_update": False, "compiled_compute": False},
                    compiled_update=False, compiled_compute=False, **kw)
    return coll


def _feed(pkg, coll, preds, target, softmax=False):
    p, t = _conv(pkg, preds, target)
    if softmax:
        p = jax.nn.softmax(p, axis=1) if pkg is mt_jax else torch.softmax(p, dim=1)
    coll.update(p, t)


def _view_paths(view: dict) -> dict:
    """The partition view member by member: path, and whether a reason is set."""
    return {kind: {name: (info["path"], bool(info["reason"])) for name, info in view[kind].items()}
            for kind in ("update", "compute")}


class _HostReadback:
    """A metric whose update reads a value back to the host (untraceable,
    uncapturable), built for either package."""

    @staticmethod
    def make(pkg):
        xp = jnp if pkg is mt_jax else torch

        class HostReadbackMetric(pkg.Metric):
            full_state_update = False

            def __init__(self, **kw):
                super().__init__(**kw)
                self.add_state("total", xp.asarray(0.0) if pkg is mt_jax else torch.tensor(0.0), dist_reduce_fx="sum")

            def update(self, preds, target):
                if float(preds.sum()) > -1e30:
                    self.total = self.total + preds.sum()

            def compute(self):
                return self.total

        return HostReadbackMetric(**_kw(pkg))


# --------------------------------------------------------------------------- #
# the main path's collection against JAX
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("buckets", [False, True], ids=["defaults", "batch_buckets"])
def test_main_path_collection_matches_jax(buckets):
    sizes = [64] * 5 + [37]
    runs = {}
    for pkg in (mt_torch, mt_jax):
        coll = _config2(pkg, binned=True, member_kw={"batch_buckets": buckets})
        values = []
        for s, n in enumerate(sizes):
            _feed(pkg, coll, *_data(n=n, seed=s), softmax=True)
            if s >= 3:
                values.append(coll.compute())
        runs[pkg] = (coll, values)
    eager = _eager_twin(mt_torch, binned=True)
    eager_values = []
    for s, n in enumerate(sizes):
        _feed(mt_torch, eager, *_data(n=n, seed=s), softmax=True)
        if s >= 3:
            eager_values.append(eager.compute())
    (got, got_values), (want, want_values) = runs[mt_torch], runs[mt_jax]
    for name in got.keys(keep_base=True):
        for key, value in got[name].get_state().items():
            if value.dtype == torch.int32:
                assert_bitwise(value, want[name].get_state()[key], f"{name}.{key}")
            else:
                assert_close(value, want[name].get_state()[key], msg=f"{name}.{key}")
            assert_bitwise(value, eager[name].get_state()[key], f"{name}.{key} against eager")
    for g, w, e in zip(got_values, want_values, eager_values):
        for key in e:
            for a, b in zip(torch.utils._pytree.tree_leaves(g[key]), torch.utils._pytree.tree_leaves(e[key])):
                assert_bitwise(a, b, key)
            for a, b in zip(torch.utils._pytree.tree_leaves(g[key]), jax.tree_util.tree_leaves(w[key])):
                assert_close(a, b, msg=key)
    assert _view_paths(got.engine_stats()["partition"]) == _view_paths(want.engine_stats()["partition"])
    for kind in ("update", "compute"):
        g, w = got.engine_stats()[kind], want.engine_stats()[kind]
        assert (g is None) == (w is None)
        if g is not None:
            assert _counters(g) == _counters(w), kind
    for name in got.keys(keep_base=True):
        for kind in ("update", "compute"):
            g, w = got[name].engine_stats()[kind], want[name].engine_stats()[kind]
            assert (g is None) == (w is None), (name, kind)
            if g is not None:
                assert _counters(g) == _counters(w), (name, kind)


@pytest.mark.parametrize("sequence", ["steady", "new_signature", "reset_between"])
def test_fused_counters_match_jax(sequence):
    steps = {
        "steady": [("update", 64, s) for s in range(5)],
        "new_signature": [("update", 64, 0), ("update", 64, 1), ("update", 16, 2), ("update", 16, 3), ("update", 64, 4)],
        "reset_between": [("update", 64, s) for s in range(4)] + [("reset",)] + [("update", 64, s) for s in range(3)],
    }[sequence]
    colls = {}
    for pkg in (mt_torch, mt_jax):
        coll = _config2(pkg)
        for op in steps:
            if op[0] == "reset":
                coll.reset()
            else:
                _feed(pkg, coll, *_data(n=op[1], seed=op[2]))
        colls[pkg] = coll
    got, want = colls[mt_torch], colls[mt_jax]
    assert _counters(got._update_engine.stats) == _counters(want._update_engine.stats)
    for name in got.keys(keep_base=True):
        for key, value in got[name].get_state().items():
            assert_bitwise(value, want[name].get_state()[key], f"{name}.{key}")
    assert got._dispatcher.stats == engine_mod.PartitionStats(**{
        k: getattr(want._dispatcher.stats, k) for k in ("builds", "repartitions", "migrations", "stable_hits",
                                                        "probations", "repromotions")})


def test_one_uncapturable_member_migrates_alone_as_in_jax():
    runs = {}
    for pkg in (mt_torch, mt_jax):
        coll = _config2(pkg)
        coll.add_metrics({"host": _HostReadback.make(pkg)})
        ref = _config2(pkg, fused_update=False)
        ref.add_metrics({"host": _HostReadback.make(pkg)})
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for s in range(5):
                _feed(pkg, coll, *_data(seed=s))
                _feed(pkg, ref, *_data(seed=s))
        assert any("engine disabled" in str(w.message) for w in caught)
        dispatcher = coll._dispatcher
        assert dispatcher.stats.migrations == 1
        assert set(dispatcher._migrated_update) == {"host"}
        assert dispatcher._partition.update_eager == ("host",)
        assert coll._update_engine.broken is None and coll._update_engine.stats.compiled_calls >= 1
        assert any(k.startswith("update:") for k in coll.engine_stats()["fallback_reasons"])
        runs[pkg] = (coll, ref)
    got, ref = runs[mt_torch]
    want, _ = runs[mt_jax]
    assert got._dispatcher._partition.update_fused == want._dispatcher._partition.update_fused
    assert _view_paths(got.engine_stats()["partition"]) == _view_paths(want.engine_stats()["partition"])
    assert _counters(got._update_engine.stats) == _counters(want._update_engine.stats)
    got_res, ref_res, want_res = got.compute(), ref.compute(), want.compute()
    for key in ref_res:
        assert_bitwise(got_res[key], ref_res[key], key)
        assert_close(got_res[key], want_res[key], msg=key)
    assert got["acc"]._update_count == 5


def test_fallback_warns_once():
    coll = mt_torch.MetricCollection({"host": _HostReadback.make(mt_torch)})
    x = torch.tensor([1.0, 2.0])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(6):
            coll.update(x, x)
    assert len([w for w in caught if "CollectionUpdateEngine" in str(w.message)]) == 1
    assert float(coll.compute()["host"]) == 18.0


# --------------------------------------------------------------------------- #
# member skip: detached between observations, whole at every observation
# --------------------------------------------------------------------------- #
def test_members_detached_between_observations():
    coll = _config2(mt_torch)
    p, t = _conv(mt_torch, *_data())
    for _ in range(3):
        coll.update(p, t)
    assert coll._members_stale
    member = coll._metrics["recall"]
    with pytest.raises(MetricsUserError, match="detached"):
        member.tp  # noqa: B018
    member = coll["recall"]  # realiases
    assert not coll._members_stale
    assert member._update_count == 3
    assert member.tp is coll["f1"].tp


def test_members_see_every_replay():
    coll = _config2(mt_torch)
    ref = _eager_twin(mt_torch)
    for s in range(6):
        for c in (coll, ref):
            _feed(mt_torch, c, *_data(seed=s))
        if s % 2:
            got, want = coll.compute(), ref.compute()
            for key in want:
                assert_bitwise(got[key], want[key], key)
            assert_bitwise(coll["precision"].tp, ref["precision"].tp, "member tp")


def test_update_counts_and_reset_after_fused_updates():
    coll = _config2(mt_torch)
    p, t = _conv(mt_torch, *_data())
    for _ in range(4):
        coll.update(p, t)
    assert {m._update_count for _, m in coll.items(keep_base=True)} == {4}
    coll.reset()
    assert {m._update_count for _, m in coll.items(keep_base=True)} == {0}
    coll.update(p, t)
    ref = _eager_twin(mt_torch)
    ref.update(p, t)
    got, want = coll.compute(), ref.compute()
    for key in want:
        assert_bitwise(got[key], want[key], key)


def test_clone_and_pickle_see_whole_members():
    coll = _config2(mt_torch)
    p, t = _conv(mt_torch, *_data())
    for _ in range(3):
        coll.update(p, t)
    assert coll._members_stale
    c = coll.clone()
    assert c._dispatcher is None and c._update_engine is None
    for _, m in c.items(keep_base=True):
        assert m._update_count == 3 and m._update_engine is None
    roundtrip = pickle.loads(pickle.dumps(coll))
    got, want = roundtrip.compute(), coll.compute()
    for key in want:
        assert_bitwise(got[key], want[key], key)


def test_group_rebuild_invalidates_and_realiases():
    coll = _config2(mt_torch)
    p, t = _conv(mt_torch, *_data())
    for _ in range(3):
        coll.update(p, t)
    stale = coll._update_engine
    coll["stat"] = mt_torch.StatScores(reduce="macro", num_classes=C, device="cpu")
    assert not coll._members_stale and coll._update_engine is None and coll._dispatcher is None
    assert coll["recall"]._update_count == 3
    coll.update(p, t)
    assert coll._update_engine is not stale
    ref = mt_torch.Recall(num_classes=C, average="macro", device="cpu", compiled_update=False)
    for _ in range(4):
        ref.update(p, t)
    assert_bitwise(coll.compute()["recall"], ref.compute(), "recall")


# --------------------------------------------------------------------------- #
# donation safety in the fused step
# --------------------------------------------------------------------------- #
def test_held_member_reference_keeps_its_value_as_in_jax():
    donated = {}
    for pkg in (mt_torch, mt_jax):
        coll = _config2(pkg)
        p, t = _conv(pkg, *_data())
        for _ in range(4):
            coll.update(p, t)
        held = coll["recall"].tp  # realias: the leader's tp
        value = np.array(held, copy=True)
        before = coll._update_engine.stats.donated_calls
        coll.update(p, t)
        assert coll._update_engine.stats.donated_calls == before
        np.testing.assert_array_equal(np.asarray(held), value)
        del held
        coll.update(p, t)
        coll.update(p, t)
        assert coll._update_engine.stats.donated_calls > before
        donated[pkg] = _counters(coll._update_engine.stats)
    assert donated[mt_torch] == donated[mt_jax]


@pytest.mark.parametrize("buckets", [False, True], ids=["fused", "bucketed"])
def test_card_replay_path_keeps_members_and_holders(monkeypatch, buckets):
    """The card's replay path (a body-running stand-in for the graph): the
    fused step in place, a held member reference kept, the bucketed group
    leader's shared state backed up around every replay; bitwise as eager."""
    use_card_replay_path(monkeypatch)
    coll = _config2(mt_torch, binned=True, member_kw={"batch_buckets": buckets})
    ref = _eager_twin(mt_torch, binned=True)
    held = []
    for s, n in enumerate([64] * 6 + [37]):
        for c in (coll, ref):
            _feed(mt_torch, c, *_data(n=n, seed=s), softmax=True)
        if s == 3:
            held = [(coll["recall"].tp, coll["recall"].tp.clone()), (coll["binned"].TPs, coll["binned"].TPs.clone())]
        if s == 5:
            for tensor, value in held:
                assert torch.equal(tensor, value)
            held = []
    names = ("f1", "acc", "binned") if buckets else ()
    engines = [coll[name]._update_engine for name in names] if buckets else [coll._update_engine]
    for engine in engines:
        assert engine.broken is None and engine.stats.cache_hits >= 3
        assert all(isinstance(step.graph, BodyGraph) for step in engine._steps.values())
    for _ in range(3):
        for m in (*coll.values(), *ref.values()):
            m._computed = None
        got, want = coll.compute(), ref.compute()
        for key in want:
            for a, b in zip(torch.utils._pytree.tree_leaves(got[key]), torch.utils._pytree.tree_leaves(want[key])):
                assert_bitwise(a, b, key)
    for name in coll.keys(keep_base=True):
        for key, value in coll[name].get_state().items():
            assert_bitwise(value, ref[name].get_state()[key], f"{name}.{key}")


def test_held_leader_snapshot_keeps_its_values():
    coll = _config2(mt_torch)
    p, t = _conv(mt_torch, *_data())
    for _ in range(4):
        coll.update(p, t)
    snap = coll["precision"].get_state()
    values = {k: v.clone() for k, v in snap.items()}
    coll.update(p, t)
    coll.update(p, t)
    assert all(torch.equal(snap[k], values[k]) for k in snap)


# --------------------------------------------------------------------------- #
# switches
# --------------------------------------------------------------------------- #
def test_global_fused_off_reverts_to_the_eager_loop():
    mt_torch.set_fused_update(False)
    coll = _config2(mt_torch)
    p, t = _conv(mt_torch, *_data())
    for _ in range(3):
        coll.update(p, t)
    assert coll._update_engine is None
    leader = coll["f1"]
    assert leader._update_engine is not None and leader._update_engine.stats.compiled_calls >= 1


@pytest.mark.parametrize("glob,local,fused", [(False, True, True), (True, False, False)])
def test_collection_flag_beats_the_global_switch(glob, local, fused):
    mt_torch.set_fused_update(glob)
    coll = _config2(mt_torch, fused_update=local)
    p, t = _conv(mt_torch, *_data())
    for _ in range(3):
        coll.update(p, t)
    assert (coll._update_engine is not None) == fused


def test_env_flag_and_none_restore(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_FUSED_UPDATE", "0")
    mt_torch.set_fused_update(None)
    assert not mt_torch.fused_update_enabled()
    coll = _config2(mt_torch)
    p, t = _conv(mt_torch, *_data())
    coll.update(p, t)
    coll.update(p, t)
    assert coll._update_engine is None
    monkeypatch.delenv("METRICS_TPU_FUSED_UPDATE")
    assert mt_torch.fused_update_enabled()


def test_compiled_update_false_also_gates_fused():
    coll = _config2(mt_torch, compiled_update=False)
    p, t = _conv(mt_torch, *_data())
    for _ in range(3):
        coll.update(p, t)
    assert coll._update_engine is None


# --------------------------------------------------------------------------- #
# the collection compute engine
# --------------------------------------------------------------------------- #
def test_fused_compute_counters_match_jax_and_fill_member_memos():
    colls = {}
    for pkg in (mt_torch, mt_jax):
        coll = _config2(pkg)
        for s in range(3):
            _feed(pkg, coll, *_data(seed=s))
            res = coll.compute()
        for name in ("precision", "recall", "acc"):
            assert coll[name]._computed is not None
        colls[pkg] = (coll, res)
    (got, got_res), (want, want_res) = colls[mt_torch], colls[mt_jax]
    assert _counters(got._compute_engine.stats) == _counters(want._compute_engine.stats)
    for key in want_res:
        assert_close(got_res[key], want_res[key], msg=key)
        assert_bitwise(got[key]._computed, got_res[key], key)


def test_member_compute_opt_out_disables_fusion():
    coll = _config2(mt_torch)
    coll["acc"]._compiled_compute = False
    p, t = _conv(mt_torch, *_data())
    coll.update(p, t)
    coll.update(p, t)
    coll.compute()
    coll.compute()
    view = coll.engine_stats()["partition"]["compute"]
    assert view["acc"]["path"] == "eager" and view["f1"]["path"] == "fused"


def test_compute_before_update_keeps_the_warning():
    """The fused compute declines a never-updated member: the eager loop
    keeps its warning."""
    coll = mt_torch.MetricCollection({
        "f1": mt_torch.F1Score(num_classes=C, average="macro", device="cpu"),
        "precision": mt_torch.Precision(num_classes=C, average="macro", device="cpu"),
    })
    with pytest.warns(UserWarning, match="before the ``update``"):
        coll.compute()
    assert coll._compute_engine.stats.compiled_calls == 0


# --------------------------------------------------------------------------- #
# the partition
# --------------------------------------------------------------------------- #
def test_classification_matches_jax():
    cases = [({}, {}), ({"batch_buckets": True}, {}), ({"compiled_update": False, "compiled_compute": False}, {}),
             ({"compute_on_cpu": True}, {})]
    for kw, _ in cases:
        got = mt_torch.Accuracy(device="cpu", **kw)
        want = mt_jax.Accuracy(**kw)
        assert engine_mod.classify_update_member(got) == mt_jax.core.engine.classify_update_member(want)
        assert engine_mod.classify_compute_member(got) == mt_jax.core.engine.classify_compute_member(want)


def test_view_without_dispatch_is_transient():
    coll = _config2(mt_torch)
    view = coll.engine_stats()["partition"]
    assert view["builds"] == 0 and view["stable_hits"] == 0
    assert all(i["path"] == "fused" for i in view["update"].values())
    assert _view_paths(view) == _view_paths(_config2(mt_jax).engine_stats()["partition"])


def test_streak_and_reset_keep_one_partition():
    coll = _config2(mt_torch)
    p, t = _conv(mt_torch, *_data())
    for _ in range(4):
        coll.update(p, t)
    warm = coll.engine_stats()["update"]
    misses, eager = warm.cache_misses, warm.eager_calls
    for _ in range(3):
        coll.reset()
        for _ in range(4):
            coll.update(p, t)
    stats = coll._dispatcher.stats
    assert (stats.builds, stats.repartitions, stats.migrations) == (1, 0, 0)
    assert stats.stable_hits == 15
    engine = coll.engine_stats()["update"]
    assert (engine.cache_misses, engine.eager_calls) == (misses, eager)


def test_flag_flip_rebuilds_and_membership_change_drops():
    coll = _config2(mt_torch)
    p, t = _conv(mt_torch, *_data())
    for _ in range(3):
        coll.update(p, t)
    coll["acc"]._compiled_update = False
    coll.update(p, t)
    part = coll._dispatcher._partition
    assert coll._dispatcher.stats.repartitions == 1 and "acc" in part.update_eager
    coll.add_metrics({"acc2": mt_torch.Accuracy(device="cpu")})
    assert coll._dispatcher is None
    coll.update(p, t)
    assert "acc2" in coll._dispatcher.partition_view()["update"]


def test_bucketed_member_coexists_with_the_fused_set():
    got = _config2(mt_torch)
    got.add_metrics({"bucketed_acc": mt_torch.Accuracy(batch_buckets=True, device="cpu")})
    ref = _eager_twin(mt_torch)
    ref.add_metrics({"bucketed_acc": mt_torch.Accuracy(compiled_update=False, device="cpu")})
    for s in range(4):
        for c in (got, ref):
            _feed(mt_torch, c, *_data(n=40 + s, seed=s))
    part = got._dispatcher._partition
    assert part.update_bucketed == ("bucketed_acc",) and "bucketed_acc" not in part.update_fused
    assert got["bucketed_acc"]._update_engine.broken is None
    got_res, ref_res = got.compute(), ref.compute()
    for key in ref_res:
        assert_bitwise(got_res[key], ref_res[key], key)


def test_probation_is_permanent_for_an_attributed_culprit():
    coll = _config2(mt_torch)
    coll.add_metrics({"host": _HostReadback.make(mt_torch)})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for s in range(4):
            _feed(mt_torch, coll, *_data(seed=s))
    view = coll.engine_stats()["partition"]
    assert view["probation"]["update:host"]["next_retry"] is None
    assert view["update"]["host"]["path"] == "eager"
    assert view["update"]["host"]["reason"].startswith("migrated at runtime: Uncapturable")

"""The compiled engines of the port (``metrics_tpu_torch/core/engine.py``)
against the JAX package's engine, per metric.

The same seeded numpy inputs go through ``metrics_tpu`` (its jit engine on,
on the CPU) and through ``metrics_tpu_torch`` (``device="cpu"``, engine on).
On the CPU the port's engine has no graph, but it runs everything else a
card runs: the signature cache, the probe, value checks off in the steady
state, in-place state behind the alias guard, bucketing and the stats. The
tests hold:

- int32 states bitwise equal to the JAX twin's and to the port's eager run;
- the ``EngineStats`` counters equal to the JAX engine's for the same calls;
- the donation-safety and lifecycle cases of
  ``tests/core/test_compiled_update_engine.py`` and
  ``tests/core/test_compiled_compute_engine.py``;
- value checks that fire on the warmup call and not in the steady state;
- the probe reverting exactly the metrics JAX's trace probe reverts;
- honest launch counts through ``CapturedStep``'s replay accounting.

The collection-level cases live in ``tests/test_torch_engine_collection.py``.
"""
import contextlib
import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt_jax
import metrics_tpu_torch as mt_torch
from metrics_tpu_torch.core import engine as engine_mod
from metrics_tpu_torch.ops import kernels as kernels_mod
from metrics_tpu_torch.utils import checks as checks_mod
from tests.helpers.torch_port import BodyGraph, assert_bitwise, assert_close, use_card_replay_path

C = 5
COUNTERS = ("eager_calls", "cache_misses", "cache_hits", "donated_calls", "bucketed_calls")


@pytest.fixture(autouse=True)
def _engines_on():
    for pkg in (mt_jax, mt_torch):
        pkg.set_compiled_update(True)
        pkg.set_compiled_compute(True)
    yield
    for pkg in (mt_jax, mt_torch):
        pkg.set_compiled_update(None)
        pkg.set_compiled_compute(None)


def _data(n=64, c=C, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, c)).astype(np.float32), rng.integers(0, c, n)


def _jax(preds, target):
    return jnp.asarray(preds), jnp.asarray(target)


def _torch(preds, target):
    return torch.from_numpy(preds.copy()), torch.from_numpy(np.asarray(target).copy())


def _counters(stats) -> dict:
    return {k: getattr(stats, k) for k in COUNTERS}


def _stat_scores(pkg, **kw):
    if pkg is mt_torch:
        kw["device"] = "cpu"
    return pkg.StatScores(reduce="macro", num_classes=C, **kw)


# --------------------------------------------------------------------------- #
# counters and states against the JAX engine, call sequence by call sequence
# --------------------------------------------------------------------------- #
# ("update", rows, seed), ("reset",), ("hold",) keeps a reference to the tp
# state, ("snapshot",) keeps get_state(), ("drop",) lets both go
SEQUENCES = {
    "steady": [("update", 64, s) for s in range(5)],
    "new_signature": [("update", 64, 0), ("update", 64, 1), ("update", 16, 2), ("update", 16, 3), ("update", 64, 4)],
    "ragged_last_batch": [("update", 64, s) for s in range(6)] + [("update", 53, 6)],
    "reset_between": [("update", 64, s) for s in range(4)] + [("reset",)] + [("update", 64, s) for s in range(4, 7)],
    "held_reference": [("update", 64, s) for s in range(4)] + [("hold",), ("update", 64, 4), ("drop",),
                                                              ("update", 64, 5), ("update", 64, 6)],
    "held_snapshot": [("update", 64, s) for s in range(4)] + [("snapshot",), ("update", 64, 4), ("drop",),
                                                             ("update", 64, 5)],
}


def _drive(pkg, metric, sequence):
    """Run ``sequence``; every held tensor must keep the value it had when it
    was taken."""
    held = []

    def check_held():
        for tensor, value in held:
            np.testing.assert_array_equal(np.asarray(tensor), value)

    for op in sequence:
        if op[0] == "update":
            metric.update(*(_jax if pkg is mt_jax else _torch)(*_data(n=op[1], seed=op[2])))
        elif op[0] == "reset":
            metric.reset()
        elif op[0] == "hold":
            held.append((metric.tp, np.array(metric.tp, copy=True)))
        elif op[0] == "snapshot":
            held.extend((v, np.array(v, copy=True)) for v in metric.get_state().values())
        elif op[0] == "drop":
            check_held()
            held.clear()
    check_held()
    return metric


@pytest.fixture()
def card_path(monkeypatch):
    use_card_replay_path(monkeypatch)


@pytest.mark.parametrize("name", sorted(SEQUENCES))
@pytest.mark.parametrize("kw", [{}, {"batch_buckets": True}, {"donate_state": False}], ids=["plain", "buckets", "no_donate"])
def test_update_counters_and_states_match_jax(name, kw):
    sequence = SEQUENCES[name]
    got = _drive(mt_torch, _stat_scores(mt_torch, **kw), sequence)
    want = _drive(mt_jax, _stat_scores(mt_jax, **kw), sequence)
    eager = _drive(mt_torch, _stat_scores(mt_torch, compiled_update=False, **kw), sequence)
    assert _counters(got._update_engine.stats) == _counters(want._update_engine.stats)
    assert eager._update_engine is None
    for key in ("tp", "fp", "tn", "fn"):
        assert_bitwise(getattr(got, key), getattr(want, key), key)
        assert_bitwise(getattr(got, key), getattr(eager, key), key)
    assert_bitwise(got.compute(), want.compute(), "compute")


@pytest.mark.parametrize("name", sorted(SEQUENCES))
@pytest.mark.parametrize("kw", [{}, {"batch_buckets": True}, {"donate_state": False}], ids=["plain", "buckets", "no_donate"])
def test_card_replay_path_matches_eager_and_keeps_holders(card_path, name, kw):
    sequence = SEQUENCES[name]
    got = _drive(mt_torch, _stat_scores(mt_torch, **kw), sequence)
    eager = _drive(mt_torch, _stat_scores(mt_torch, compiled_update=False, **kw), sequence)
    want = _drive(mt_jax, _stat_scores(mt_jax, **kw), sequence)
    assert all(isinstance(step.graph, BodyGraph) for step in got._update_engine._steps.values())
    assert _counters(got._update_engine.stats) == _counters(want._update_engine.stats)
    for key in ("tp", "fp", "tn", "fn"):
        assert_bitwise(getattr(got, key), getattr(eager, key), key)
    for _ in range(3):
        got._computed = eager._computed = None
        assert_bitwise(got.compute(), eager.compute(), "compute")
    assert got._compute_engine.stats.cache_hits == 1


def test_warmup_then_hit():
    preds, target = _torch(*_data())
    m = _stat_scores(mt_torch)
    for _ in range(4):
        m.update(preds, target)
    stats = m._update_engine.stats
    assert (stats.eager_calls, stats.cache_misses, stats.cache_hits) == (1, 1, 2)
    assert stats.compiled_calls == 3


def test_global_switch_and_instance_override():
    preds, target = _torch(*_data())
    mt_torch.set_compiled_update(False)
    m = _stat_scores(mt_torch)
    m.update(preds, target)
    assert m._update_engine is None
    m2 = _stat_scores(mt_torch, compiled_update=True)
    m2.update(preds, target)
    m2.update(preds, target)
    assert m2._update_engine.stats.compiled_calls == 1


@pytest.mark.parametrize("flag", ["compiled_update", "compiled_compute", "donate_state", "batch_buckets"])
def test_keyword_types_are_checked_as_in_jax(flag):
    with pytest.raises(ValueError, match=f"`{flag}`") as got:
        _stat_scores(mt_torch, **{flag: "yes"})
    with pytest.raises(ValueError, match=f"`{flag}`") as want:
        _stat_scores(mt_jax, **{flag: "yes"})
    assert str(got.value) == str(want.value)


def test_list_state_metric_stays_eager():
    """samples-reduced stat scores keep list states: no capture, as in JAX."""
    got = mt_torch.StatScores(reduce="samples", device="cpu")
    want = mt_jax.StatScores(reduce="samples")
    for s in range(3):
        preds, target = _data(seed=s)
        got.update(*_torch(preds, target))
        want.update(*_jax(preds, target))
    assert not got.supports_compiled_update
    assert got._update_engine.stats.compiled_calls == want._update_engine.stats.compiled_calls == 0


# --------------------------------------------------------------------------- #
# the compute engine
# --------------------------------------------------------------------------- #
def test_compute_counters_match_jax():
    engines = []
    for pkg, conv in ((mt_torch, _torch), (mt_jax, _jax)):
        m = _stat_scores(pkg)
        values = []
        for s in range(3):
            m.update(*conv(*_data(seed=s)))
            values.append(m.compute())
        engines.append((m, values))
    (got, got_values), (want, want_values) = engines
    assert _counters(got._compute_engine.stats) == _counters(want._compute_engine.stats)
    assert (got._compute_engine.stats.eager_calls, got._compute_engine.stats.cache_misses,
            got._compute_engine.stats.cache_hits) == (1, 1, 1)
    for g, w in zip(got_values, want_values):
        assert_bitwise(g, w, "compute")


def test_memoized_compute_skips_engine():
    m = mt_torch.Accuracy(device="cpu")
    m.update(*_torch(*_data()))
    v1 = m.compute()
    before = m._compute_engine.stats.eager_calls
    assert m.compute() is v1
    assert m._compute_engine.stats.eager_calls == before


@pytest.mark.parametrize("cls", ["Accuracy", "F1Score", "Precision", "Recall", "BinnedAveragePrecision"])
def test_compiled_compute_is_bitwise_eager(cls):
    kw = {"num_classes": C} if cls == "BinnedAveragePrecision" else {"num_classes": C, "average": "macro"}
    got = getattr(mt_torch, cls)(device="cpu", **kw)
    ref = getattr(mt_torch, cls)(device="cpu", compiled_update=False, compiled_compute=False, **kw)
    for s in range(3):
        preds, target = _torch(*_data(seed=s))
        preds = torch.softmax(preds, dim=1)
        for m in (got, ref):
            m.update(preds, target)
        g, r = got.compute(), ref.compute()
        for a, b in zip(torch.utils._pytree.tree_leaves(g), torch.utils._pytree.tree_leaves(r)):
            assert_bitwise(a, b, cls)
    assert got._compute_engine.stats.compiled_calls == 2 and got._compute_engine.broken is None


# --------------------------------------------------------------------------- #
# donation safety: in-place state never reaches a tensor someone still holds
# --------------------------------------------------------------------------- #
def test_held_state_reference_keeps_its_value():
    preds, target = _torch(*_data())
    m = _stat_scores(mt_torch)
    for _ in range(4):
        m.update(preds, target)
    held = m.tp
    value = held.clone()
    donated = m._update_engine.stats.donated_calls
    m.update(preds, target)
    assert m._update_engine.stats.donated_calls == donated
    assert torch.equal(held, value)
    del held
    m.update(preds, target)
    m.update(preds, target)
    assert m._update_engine.stats.donated_calls > donated


def test_held_snapshot_keeps_its_values():
    preds, target = _torch(*_data())
    m = _stat_scores(mt_torch)
    for _ in range(4):
        m.update(preds, target)
    snap = m.get_state()
    values = {k: v.clone() for k, v in snap.items()}
    for _ in range(3):
        m.update(preds, target)
    assert all(torch.equal(snap[k], values[k]) for k in snap)


def test_steady_state_updates_in_place():
    preds, target = _torch(*_data())
    m = _stat_scores(mt_torch)
    for _ in range(3):
        m.update(preds, target)
    tensors = {k: v for k, v in m.get_state().items()}
    ids = {k: id(v) for k, v in tensors.items()}
    del tensors
    m.update(preds, target)
    assert {k: id(v) for k, v in m.get_state().items()} == ids
    assert m._update_engine.stats.donated_calls == 2


def test_defaults_are_never_written():
    preds, target = _torch(*_data())
    m = _stat_scores(mt_torch)
    defaults = {k: v.clone() for k, v in m._defaults.items()}
    for _ in range(4):
        m.update(preds, target)
    m.reset()
    reset_state = {k: v for k, v in m.get_state().items()}
    donated = m._update_engine.stats.donated_calls
    m.update(preds, target)
    assert m._update_engine.stats.donated_calls == donated  # the reset copies stand for the defaults
    assert all(torch.equal(m._defaults[k], defaults[k]) for k in defaults)
    assert all(torch.equal(v, defaults[k]) for k, v in reset_state.items())


def test_donate_state_false_never_writes_in_place():
    m = _stat_scores(mt_torch, donate_state=False)
    seen = []
    for s in range(6):
        m.update(*_torch(*_data(seed=s)))
        seen.append({k: (v, v.clone()) for k, v in m.get_state().items()})
    for state in seen:
        assert all(torch.equal(t, copy) for t, copy in state.values())
    assert m._update_engine.stats.compiled_calls == 5
    assert m._update_engine.stats.donated_calls == 0


# --------------------------------------------------------------------------- #
# bucketing
# --------------------------------------------------------------------------- #
RAGGED = [100, 37, 64, 13, 100, 99, 5, 1]


def test_mask_path_is_bitwise_eager_and_matches_jax():
    rng = np.random.default_rng(1)
    got = _stat_scores(mt_torch, batch_buckets=True)
    ref = _stat_scores(mt_torch, compiled_update=False)
    want = _stat_scores(mt_jax, batch_buckets=True)
    for n in RAGGED:
        preds, target = rng.standard_normal((n, C)).astype(np.float32), rng.integers(0, C, n)
        got.update(*_torch(preds, target))
        ref.update(*_torch(preds, target))
        want.update(*_jax(preds, target))
    assert_bitwise(got.compute(), ref.compute(), "mask route against eager")
    assert_bitwise(got.compute(), want.compute(), "mask route against JAX")
    assert got._update_engine.stats.bucketed_calls == len(RAGGED)
    assert len(got._update_engine._seen) <= 5
    assert _counters(got._update_engine.stats) == _counters(want._update_engine.stats)


def test_chunk_path_is_bitwise_eager_and_matches_jax():
    """The binned curves take no mask: ragged batches split into pow2 chunks."""
    rng = np.random.default_rng(2)
    got = mt_torch.BinnedPrecisionRecallCurve(num_classes=C, thresholds=11, batch_buckets=True, device="cpu")
    ref = mt_torch.BinnedPrecisionRecallCurve(num_classes=C, thresholds=11, compiled_update=False, device="cpu")
    want = mt_jax.BinnedPrecisionRecallCurve(num_classes=C, thresholds=11, batch_buckets=True)
    for n in RAGGED:
        probs = rng.uniform(size=(n, C)).astype(np.float32)
        target = rng.integers(0, C, n)
        got.update(*_torch(probs, target))
        ref.update(*_torch(probs, target))
        want.update(jnp.asarray(probs), jnp.asarray(np.eye(C, dtype=np.int32)[target]))
    for key in ("TPs", "FPs", "FNs"):
        assert_bitwise(getattr(got, key), getattr(ref, key), key)
        assert_close(getattr(got, key), getattr(want, key), msg=key)
    assert _counters(got._update_engine.stats) == _counters(want._update_engine.stats)
    assert got._update_engine.stats.bucketed_calls == len(RAGGED)


# --------------------------------------------------------------------------- #
# lifecycle
# --------------------------------------------------------------------------- #
def test_clone_and_pickle_drop_the_engines():
    preds, target = _torch(*_data())
    m = _stat_scores(mt_torch)
    for _ in range(3):
        m.update(preds, target)
        m.compute()
    assert m._update_engine is not None and m._compute_engine is not None
    c = m.clone()
    assert c._update_engine is None and c._compute_engine is None
    c.update(preds, target)
    assert c._update_engine is not None  # rebuilt lazily
    p = pickle.loads(pickle.dumps(m))
    assert p._update_engine is None and p._compute_engine is None
    assert_bitwise(p.compute(), m.compute(), "pickled")


def test_move_drops_the_engines():
    m = _stat_scores(mt_torch)
    for _ in range(3):
        m.update(*_torch(*_data()))
    m.to("cpu")
    assert m._update_engine is None and m._compute_engine is None


def test_reset_keeps_the_cache():
    preds, target = _torch(*_data())
    m = _stat_scores(mt_torch)
    for _ in range(3):
        m.update(preds, target)
        m.compute()
    misses = (m._update_engine.stats.cache_misses, m._compute_engine.stats.cache_misses)
    m.reset()
    m.update(preds, target)
    m.compute()
    assert (m._update_engine.stats.cache_misses, m._compute_engine.stats.cache_misses) == misses
    ref = _stat_scores(mt_torch, compiled_update=False, compiled_compute=False)
    ref.update(preds, target)
    assert_bitwise(m.compute(), ref.compute(), "after reset")


def test_load_state_dict_drops_the_identity_memos():
    preds, target = _torch(*_data())
    m = _stat_scores(mt_torch)
    m.persistent(True)
    for _ in range(3):
        m.update(preds, target)
    sd = m.state_dict()
    m.load_state_dict(sd)
    m.update(preds, target)
    ref = _stat_scores(mt_torch, compiled_update=False)
    for _ in range(4):
        ref.update(preds, target)
    assert_bitwise(m.tp, ref.tp, "tp")


# --------------------------------------------------------------------------- #
# value checks: on the warmup call, not in the steady state
# --------------------------------------------------------------------------- #
def test_capturing_flag():
    assert not checks_mod._capturing()
    with checks_mod._checks_off():
        assert checks_mod._capturing()
        with checks_mod._checks_off():
            assert checks_mod._capturing()
        assert checks_mod._capturing()
    assert not checks_mod._capturing()


@pytest.mark.parametrize("pkg", [mt_torch, mt_jax], ids=["torch", "jax"])
def test_value_checks_fire_on_warmup_only(pkg):
    conv = _torch if pkg is mt_torch else _jax
    preds, target = _data()
    bad = np.array(target, copy=True)
    bad[0] = C + 2  # a label beyond num_classes
    m = _stat_scores(pkg)
    with pytest.raises(ValueError, match="contains a label >="):
        m.update(*conv(preds[:32], bad[:32]))  # warmup of a new shape: checked
    m.update(*conv(preds, target))  # warmup
    m.update(*conv(preds, target))  # probe
    m.update(*conv(preds, bad))  # steady state: not checked (the bad row is dropped)
    assert m._update_engine.stats.cache_hits == 1


def test_steady_state_runs_with_checks_off(monkeypatch):
    calls = []
    real = checks_mod._basic_input_validation

    def spy(preds, target, *args, **kwargs):
        calls.append(checks_mod._capturing())
        return real(preds, target, *args, **kwargs)

    monkeypatch.setattr(checks_mod, "_basic_input_validation", spy)
    m = _stat_scores(mt_torch)
    preds, target = _torch(*_data())
    for _ in range(4):
        m.update(preds, target)
    assert calls == [False, True, True, True]


# --------------------------------------------------------------------------- #
# the probe reverts what JAX's trace probe reverts
# --------------------------------------------------------------------------- #
def _host_metric(pkg, body):
    xp = jnp if pkg is mt_jax else torch

    class Probe(pkg.Metric):
        full_state_update = False

        def __init__(self, **kw):
            if pkg is mt_torch:
                kw["device"] = "cpu"
            super().__init__(**kw)
            self.add_state("total", xp.asarray(0.0) if pkg is mt_jax else torch.tensor(0.0), dist_reduce_fx="sum")

        def update(self, x):
            self.total = self.total + body(xp, x)

        def compute(self):
            return self.total

    return Probe()


PROBES = {
    "bool": (lambda xp, x: x.sum() if bool(x.sum() > -1e30) else x.sum(), True),
    "item": (lambda xp, x: x.sum() * 0 + x.sum().item(), True),
    "int": (lambda xp, x: x.sum() + int(x.max()), True),
    "tolist": (lambda xp, x: x.sum() + sum(x.tolist()), True),
    "bool_index": (lambda xp, x: x[x > 0].sum(), True),
    "nonzero": (lambda xp, x: xp.nonzero(x > 0)[0].sum().astype(x.dtype) if xp is jnp else torch.nonzero(x > 0).sum().to(x.dtype), True),
    "unique": (lambda xp, x: xp.unique(x).sum(), True),
    "capturable": (lambda xp, x: (x * 2).sum(), False),
}


@pytest.mark.parametrize("name", sorted(PROBES))
def test_probe_reverts_what_jax_reverts(name):
    body, reverts = PROBES[name]
    rng = np.random.default_rng(5)
    results = {}
    for pkg in (mt_torch, mt_jax):
        m = _host_metric(pkg, body)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(4):
                x = rng.standard_normal(16).astype(np.float32)
                m.update(jnp.asarray(x) if pkg is mt_jax else torch.from_numpy(x))
        engine = m._update_engine
        results[pkg.__name__] = (engine.broken is not None, _counters(engine.stats),
                                 any("engine disabled" in str(w.message) for w in caught))
        view = m.engine_stats()["partition"]["update"]
        assert (view["path"] == "eager") == reverts
        rng = np.random.default_rng(5)
    assert results["metrics_tpu_torch"] == results["metrics_tpu"]
    assert results["metrics_tpu_torch"][0] == reverts


def test_label_inputs_without_num_classes_revert_on_both_sides():
    """Inferring the class count from the values is a host read: the probe
    catches it (the JAX package raises under the trace and reverts)."""
    rng = np.random.default_rng(6)
    states = {}
    for pkg, conv in ((mt_torch, _torch), (mt_jax, _jax)):
        m = pkg.StatScores(reduce="micro", **({"device": "cpu"} if pkg is mt_torch else {}))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for _ in range(3):
                m.update(*conv(rng.integers(0, C, 40), rng.integers(0, C, 40)))
        assert m._update_engine.broken is not None
        states[pkg] = m
        rng = np.random.default_rng(6)
    assert_bitwise(states[mt_torch].tp, states[mt_jax].tp, "tp")
    assert _counters(states[mt_torch]._update_engine.stats) == _counters(states[mt_jax]._update_engine.stats)


def test_untraceable_update_falls_back_permanently():
    m = _host_metric(mt_torch, PROBES["bool"][0])
    x = torch.tensor([1.0, 2.0])
    m.update(x)
    with pytest.warns(UserWarning, match="compiled-update engine disabled"):
        m.update(x)
    assert m._update_engine.broken is not None
    m.update(x)
    assert float(m.compute()) == 9.0  # all three updates applied eagerly
    assert m._update_engine.stats.compiled_calls == 0
    view = m.engine_stats()
    assert view["partition"]["update"]["path"] == "eager"
    assert "runtime fallback" in view["partition"]["update"]["reason"]
    assert list(view["fallback_reasons"]) == ["update:Probe"]


def test_untraceable_compute_falls_back_permanently():
    class HostCompute(mt_torch.Metric):
        full_state_update = False

        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

        def update(self, x):
            self.total = self.total + x.sum()

        def compute(self):
            return self.total + 0.0 if float(self.total) > -1e30 else self.total

    m = HostCompute()
    x = torch.tensor([1.0, 2.0])
    m.update(x)
    assert float(m.compute()) == 3.0
    m.update(x)
    with pytest.warns(UserWarning, match="compiled-compute engine disabled"):
        m.compute()
    assert m._compute_engine.broken is not None
    m.update(x)
    assert float(m.compute()) == 9.0
    assert m._compute_engine.stats.compiled_calls == 0


# --------------------------------------------------------------------------- #
# launch counts through CapturedStep's accounting
# --------------------------------------------------------------------------- #
class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: a capture that records and a replay
    that launches nothing of its own."""

    replays = 0

    def replay(self):
        _FakeGraph.replays += 1


def test_captured_step_counts_a_launch_per_replay(monkeypatch):
    kernel = kernels_mod.CUDA_KERNELS["binned_counts"]

    def step(state, args, kwargs):
        kernel.launches += 1  # what a kernel wrapper does where it launches
        return {"x": state["x"] + args[0]}

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, pool=None, stream=None, capture_error_mode=None: contextlib.nullcontext())
    kernels_mod.reset_launch_counts()
    captured = engine_mod.CapturedStep(step, writes_state=True)
    state, args = {"x": torch.zeros(3)}, (torch.ones(3),)
    out = captured.fn(state, args, {})  # the probe's run: a real launch
    captured._state_spec = engine_mod.tree_flatten(state)[1]
    captured._args_spec = engine_mod.tree_flatten((args, {}))[1]
    captured._consts = [None]
    captured._make_statics([state["x"]], [args[0]], [out["x"]])
    assert kernels_mod.launch_counts()["binned_counts"] == 1
    captured._capture(side=None)  # runs the body once: records, launches nothing
    assert captured.launch_delta == {"binned_counts": 1}
    assert kernels_mod.launch_counts()["binned_counts"] == 1
    for n in range(3):
        captured.replay()
        assert kernels_mod.launch_counts()["binned_counts"] == 2 + n
    kernels_mod.add_launches({"binned_counts": -4})
    assert kernels_mod.launch_counts()["binned_counts"] == 0


def test_a_failed_capture_takes_its_counts_back(monkeypatch):
    kernel = kernels_mod.CUDA_KERNELS["pairwise_iou"]

    def step(state, args, kwargs):
        kernel.launches += 1
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, pool=None, stream=None, capture_error_mode=None: contextlib.nullcontext())
    kernels_mod.reset_launch_counts()
    captured = engine_mod.CapturedStep(step, writes_state=True)
    captured._state_spec = engine_mod.tree_flatten({"x": torch.zeros(1)})[1]
    captured._args_spec = engine_mod.tree_flatten(((), {}))[1]
    captured.state_static = [torch.zeros(1)]
    with pytest.raises(engine_mod.Uncapturable, match="capture refused"):
        captured._capture(side=None)
    assert kernels_mod.launch_counts()["pairwise_iou"] == 0


def test_compute_outputs_pack_into_flat_statics():
    """A compute step's outputs go through one flat static buffer per dtype
    and come back as fresh tensors of the step's own tree (the card's path,
    with the body run directly in place of a replay)."""

    def step(state, args, kwargs):
        x = state["x"]
        return {"rows": list(x * 2), "total": x.sum(), "count": (x > 0).sum(dtype=torch.int32), "last": x[-1:] + 1}

    captured = engine_mod.CapturedStep(step, writes_state=False)
    state = {"x": torch.arange(-3.0, 7.0)}
    want = step(state, (), {})
    captured._state_spec = engine_mod.tree_flatten(state)[1]
    captured._args_spec = engine_mod.tree_flatten(((), {}))[1]
    out_leaves, captured._out_spec = engine_mod.tree_flatten(want)
    captured._make_statics([state["x"]], [], out_leaves)
    # the ten rows and the total are one run of 0-d float32
    assert [(dtype, tuple(shape), count) for dtype, shape, _, count in captured._out_layout] == [
        (torch.float32, (), 11), (torch.int32, (), 1), (torch.float32, (1,), 1)]
    captured.state_static[0].copy_(state["x"])
    captured._body()
    got = captured._unpack_outputs()
    for g, w in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
        assert_bitwise(g, w, "output")
    again = captured._unpack_outputs()
    assert again["total"].data_ptr() != got["total"].data_ptr()  # every call hands out fresh tensors
    # the rows are views of one tensor, back to back: one block copy; the run
    # they form with the total is not, and takes a cat
    rows = list(torch.arange(6.0) * 2)
    assert torch.equal(engine_mod._one_block(rows, 1), torch.arange(6.0) * 2)
    assert engine_mod._one_block(rows + [torch.tensor(1.0)], 1) is None


def test_a_kernel_error_is_not_caught(monkeypatch):
    """Only a capture's refusal reverts a metric; any other error propagates."""

    class Failing(mt_torch.Metric):
        full_state_update = False

        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")
            self.calls = 0

        def update(self, x):
            self.calls += 1
            if self.calls == 2:
                raise RuntimeError("binned_counts kernel launch failed with CUDA error 700")
            self.total = self.total + x.sum()

        def compute(self):
            return self.total

    m = Failing()
    m.update(torch.ones(2))
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        m.update(torch.ones(2))
    assert m._update_engine.broken is None


def test_engine_stats_shape():
    m = _stat_scores(mt_torch, batch_buckets=True)
    stats = m.engine_stats()
    assert stats["update"] is None and stats["compute"] is None
    assert stats["partition"]["update"]["path"] == "bucketed"
    assert stats["partition"]["compute"]["path"] == "fused"
    for _ in range(2):
        m.update(*_torch(*_data()))
    stats = m.engine_stats()
    assert isinstance(stats["update"], engine_mod.EngineStats)
    assert stats["fallback_reasons"] == {}


def test_pow2_helpers_match_jax():
    from metrics_tpu.core import engine as jax_engine

    for n in (1, 2, 3, 13, 64, 100, 848, 1024, 50_000):
        assert engine_mod._next_pow2(n) == jax_engine._next_pow2(n)
        assert engine_mod._pow2_chunks(n) == jax_engine._pow2_chunks(n)

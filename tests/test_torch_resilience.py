"""The port's resilience layer (``metrics_tpu_torch.resilience``) against the JAX package's.

Chaos: a seeded plan fires at the same calls in both packages (stdlib
``random.Random`` seeded from the plan), on bare sites and on the wired
ones: the engines' ``engine/compile`` and ``engine/dispatch`` (``nth``,
``every``, ``probability``) on the config2 collection, where the
dispatcher's probation makes the final compute bitwise equal to the
fault-free run, and the sync's ``sync/bucket_build`` and
``sync/incremental`` (the port in a gloo world of one rank in this process,
the JAX package under ``jax.make_jaxpr`` with an axis of one). The card
runs a step's body twice (the probe, then the capture): a stand-in for the
capture's second run shows that it fires no fault and records no event.
Only ``Uncapturable`` and an injected ``ChaosError`` revert an engine;
any other error propagates.

Retry: equal backoff sequences for the same seed, the same attempts and
classification. Guard: quarantine rolls a NaN batch back bit for bit,
``raise`` names the leaf, and the guard checks nothing inside a step.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import metrics_tpu as mj
import metrics_tpu_torch as mt
from metrics_tpu.resilience import FaultSpec as JFaultSpec
from metrics_tpu.resilience import chaos as jchaos
from metrics_tpu.resilience import guard as jguard
from metrics_tpu.resilience import retry as jretry
from metrics_tpu_torch import observability as tobs
from metrics_tpu_torch.core import engine as tengine
from metrics_tpu_torch.parallel import sync as tsync
from metrics_tpu_torch.resilience import ChaosError, FaultSpec, NonFiniteStateError, RetryPolicy, call_with_retry
from metrics_tpu_torch.resilience import chaos as tchaos
from metrics_tpu_torch.resilience import guard as tguard
from metrics_tpu_torch.resilience import retry as tretry
from tests.helpers.torch_port import BodyGraph, assert_bitwise, one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.filterwarnings("ignore::UserWarning"), pytest.mark.usefixtures("one_torch_thread")]

C, BATCH = 6, 16


def _batches(seed=0, steps=4):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(BATCH, C)).astype(np.float32), rng.integers(0, C, BATCH).astype(np.int32))
            for _ in range(steps)]


def _jax_config2():
    return mj.MetricCollection({
        "acc": mj.Accuracy(num_classes=C, average="micro"),
        "f1": mj.F1Score(num_classes=C, average="macro"),
        "precision": mj.Precision(num_classes=C, average="macro"),
        "recall": mj.Recall(num_classes=C, average="macro"),
    })


def _torch_config2():
    return mt.MetricCollection({
        "acc": mt.Accuracy(num_classes=C, average="micro", device="cpu"),
        "f1": mt.F1Score(num_classes=C, average="macro", device="cpu"),
        "precision": mt.Precision(num_classes=C, average="macro", device="cpu"),
        "recall": mt.Recall(num_classes=C, average="macro", device="cpu"),
    })


def _log(plan):
    return [(e.site, e.kind, e.call, e.spec_index) for e in plan.log]


@pytest.fixture(autouse=True)
def _pristine():
    yield
    for chaos, guard, set_probation in ((tchaos, tguard, mt.set_probation), (jchaos, jguard, mj.set_probation)):
        chaos.uninstall()
        guard.set_guard(None)
        set_probation(None)


@pytest.fixture(scope="module")
def world1():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


# --------------------------------------------------------------------------- #
# chaos: the schedule
# --------------------------------------------------------------------------- #
SCHEDULES = {
    "nth": [dict(site="a/x", nth=3)],
    "every_times": [dict(site="a/x", every=2, times=3)],
    "probability": [dict(site="a/x", probability=0.4), dict(site="b/y", probability=0.4)],
    "wildcard_latency": [dict(site="a/*", every=5), dict(site="b/y", kind="latency", latency_s=0.0, nth=2)],
    "non_transient": [dict(site="b/y", transient=False, probability=0.5, times=5)],
}


def _run_schedule(chaos, spec_cls, error_cls, specs, seed):
    fired = []
    with chaos.plan([spec_cls(**s) for s in specs], seed=seed) as plan:
        for i in range(40):
            for site in ("a/x", "b/y"):
                try:
                    chaos.maybe_fail(site)
                except error_cls as err:
                    fired.append((i, site, err.transient))
    return fired, _log(plan)


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_fire_at_the_jax_packages_calls(name, seed):
    got = _run_schedule(tchaos, FaultSpec, ChaosError, SCHEDULES[name], seed)
    want = _run_schedule(jchaos, JFaultSpec, jchaos.ChaosError, SCHEDULES[name], seed)
    assert got == want
    assert got[1]
    assert tchaos.KNOWN_SITES == jchaos.KNOWN_SITES and not tchaos.active


def test_spec_validation_and_partial_writes_match():
    for bad in (dict(kind="explode"), dict(nth=2, every=3), dict(probability=1.5), dict(nth=0),
                dict(kind="partial_write", fraction=1.0)):
        with pytest.raises(ValueError):
            FaultSpec("x", **bad)
        with pytest.raises(ValueError):
            JFaultSpec("x", **bad)
    fractions = []
    for chaos, spec in ((tchaos, FaultSpec), (jchaos, JFaultSpec)):
        with chaos.plan([spec("ckpt/write", kind="partial_write", every=2, fraction=0.25)], seed=3):
            fractions.append([chaos.partial_write_fraction("ckpt/write") for _ in range(5)])
    assert fractions[0] == fractions[1] == [None, 0.25, None, 0.25, None]


# --------------------------------------------------------------------------- #
# chaos: the engines' sites, probation
# --------------------------------------------------------------------------- #
ENGINE_SPECS = [
    dict(site="engine/compile", nth=1),
    dict(site="engine/dispatch", every=3, times=3),
    dict(site="engine/dispatch", probability=0.3, times=4),
]
STREAM = _batches(5, steps=14)


def _jax_engine_run(specs):
    mj.set_probation(2)
    coll = _jax_config2()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if specs is None:
            log = None
            for logits, target in STREAM:
                coll.update(jnp.asarray(logits), jnp.asarray(target))
        else:
            with jchaos.plan([JFaultSpec(**s) for s in specs], seed=7) as plan:
                for logits, target in STREAM:
                    coll.update(jnp.asarray(logits), jnp.asarray(target))
            log = _log(plan)
        values = {k: np.asarray(v) for k, v in coll.compute().items()}
    mj.set_probation(None)
    return values, log, coll._dispatcher.stats


@pytest.fixture(scope="module")
def jax_engine_runs():
    return {"clean": _jax_engine_run(None), "faulted": _jax_engine_run(ENGINE_SPECS)}


def _torch_engine_run(specs, events=None):
    mt.set_probation(2)
    coll = _torch_config2()
    log = None
    with tobs.trace() as tracer:
        if specs is None:
            for logits, target in STREAM:
                coll.update(torch.from_numpy(logits), torch.from_numpy(target))
        else:
            with tchaos.plan([FaultSpec(**s) for s in specs], seed=7) as plan:
                for logits, target in STREAM:
                    coll.update(torch.from_numpy(logits), torch.from_numpy(target))
            log = _log(plan)
        values = coll.compute()
    if events is not None:
        events.extend(tracer.events())
    mt.set_probation(None)
    return values, log, coll._dispatcher.stats


def test_engine_faults_fire_at_the_jax_packages_calls_and_probation_restores_bitwise(jax_engine_runs):
    clean, _, _ = _torch_engine_run(None)
    events = []
    faulted, log, stats = _torch_engine_run(ENGINE_SPECS, events)
    _, want_log, want_stats = jax_engine_runs["faulted"]
    assert log == want_log and len(log) == 5
    assert vars(stats) == vars(want_stats) and stats.repromotions > 0
    for key, value in clean.items():
        assert_bitwise(faulted[key], value, key)
        np.testing.assert_allclose(value.numpy(), jax_engine_runs["clean"][0][key], rtol=1e-6)
    names = [e.name for e in events]
    assert names.count("chaos/fault") == 5
    assert sum(len(e.args["members"]) for e in events if e.name == "partition/migrate") == stats.migrations
    assert names.count("partition/repromote") > 0
    fallbacks = [e for e in events if e.name == "dispatch/fallback"]
    assert fallbacks and all("ChaosError" in e.args["reason"] for e in fallbacks)


def test_a_fault_on_one_metric_reverts_it_to_eager_bit_for_bit():
    stream = _batches(6)
    clean = mt.Accuracy(device="cpu")
    faulted = mt.Accuracy(device="cpu")
    logs = []
    for chaos, spec, make, arr in ((tchaos, FaultSpec, lambda: faulted, torch.from_numpy),
                                   (jchaos, JFaultSpec, mj.Accuracy, jnp.asarray)):
        metric = make()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with chaos.plan([spec("engine/dispatch", nth=1)]) as plan:
                for logits, target in stream:
                    metric.update(arr(logits), arr(target))
        logs.append(_log(plan))
        assert "ChaosError" in metric.engine_stats()["fallback_reasons"]["update:Accuracy"]
    for logits, target in stream:
        clean.update(torch.from_numpy(logits), torch.from_numpy(target))
    assert logs[0] == logs[1] == [("engine/dispatch", "error", 1, 0)]
    assert faulted._update_engine.broken is not None
    for key, value in clean.get_state().items():
        assert_bitwise(faulted.get_state()[key], value, key)


def test_only_uncapturable_and_chaos_revert_an_engine():
    """A kernel's build or launch error (here any RuntimeError that is not a
    refused capture) propagates through the engine, which stays healthy."""

    class Faulty(mt.SumMetric):
        fail = False

        def update(self, value):
            if Faulty.fail:
                raise RuntimeError("the kernel failed to launch")
            super().update(value)

    m = Faulty(device="cpu")
    m.update(torch.ones(3))
    Faulty.fail = True
    with pytest.raises(RuntimeError, match="failed to launch"):
        m.update(torch.ones(3))  # the probe call
    assert m._update_engine.broken is None and not m.engine_stats()["fallback_reasons"]


def test_sync_faults_fire_at_the_jax_packages_calls(world1):
    """``sync/bucket_build`` fires once per sync_state (one per compute
    group), ``sync/incremental`` once per emission, in both packages."""
    specs = [dict(site="sync/bucket_build", nth=2), dict(site="sync/incremental", every=2)]
    logs = []
    for side in ("jax", "torch"):
        coll = _jax_config2() if side == "jax" else _torch_config2()
        chaos, spec = (jchaos, JFaultSpec) if side == "jax" else (tchaos, FaultSpec)
        arr = jnp.asarray if side == "jax" else torch.from_numpy
        states = coll.init_state()
        for logits, target in _batches(7):
            states = coll.update_state(states, arr(logits), arr(target))
        with chaos.plan([spec(**s) for s in specs]) as plan:
            with pytest.raises(chaos.ChaosError, match="sync/bucket_build"):
                if side == "jax":
                    jax.make_jaxpr(lambda s: coll.sync_compute_state(s, "data"), axis_env=[("data", 1)])(states)
                else:
                    coll.sync_compute_state(states, world1)
            (mj if side == "jax" else mt).parallel.set_sync_mode("incremental")
            try:
                with pytest.raises(chaos.ChaosError, match="sync/incremental"):
                    if side == "jax":
                        def streak(st):
                            carry = coll.init_incremental(st, sync_every=1)
                            for logits, target in _batches(8):
                                carry = coll.update_state_incremental(carry, jnp.asarray(logits), jnp.asarray(target),
                                                                      axis_name="data")
                            return carry

                        jax.make_jaxpr(streak, axis_env=[("data", 1)])(states)
                    else:
                        carry = coll.init_incremental(states, sync_every=1)
                        for logits, target in _batches(8):
                            carry = coll.update_state_incremental(carry, torch.from_numpy(logits),
                                                                  torch.from_numpy(target), group=world1)
            finally:
                (mj if side == "jax" else mt).parallel.set_sync_mode(None)
        logs.append(_log(plan))
    assert logs[0] == logs[1] == [("sync/bucket_build", "error", 2, 0), ("sync/incremental", "error", 2, 1)]


def _capture_twice(monkeypatch):
    """A CPU stand-in for the card's capture: after the probe, the step's
    body runs once more as ``CapturedStep._capture`` runs it (value checks
    off, the sync muted), then a :class:`BodyGraph` replays it."""
    probe = tengine.CapturedStep.probe

    def probe_capture_graph(self, state, args, kwargs):
        out = probe(self, state, args, kwargs)
        with tengine._steady(), tsync._muted():
            self._body()
        self.graph = BodyGraph(self)
        return out

    monkeypatch.setattr(tengine.CapturedStep, "probe", probe_capture_graph)


def _synced_computes(world):
    """Four synced computes of config2 under a plan that counts every
    sync/bucket_build call and fires at the first probe's (the third call:
    the eager first compute syncs each of the two groups once)."""
    coll = _torch_config2()
    for logits, target in _batches(9, steps=2):
        coll.update(torch.from_numpy(logits), torch.from_numpy(target))
    mt.set_probation(1)
    values = []
    with tobs.trace() as tracer, tchaos.plan([FaultSpec("sync/bucket_build", nth=3)]) as plan:
        with tsync.sync_axes(world):
            for _ in range(4):
                for m in coll.values():
                    m._computed = None
                values.append({k: v.clone() for k, v in coll.compute().items()})
    counts = {}
    for e in tracer.events():
        counts[e.name] = counts.get(e.name, 0) + 1
    return values, counts, _log(plan), plan._states[0].calls


def test_the_captures_second_run_is_quiet(world1, monkeypatch):
    """The card's second run of a probed step (the capture) and its replays
    fire no fault and record no event: the card gives the CPU's counts."""
    cpu = _synced_computes(world1)
    _capture_twice(monkeypatch)
    card = _synced_computes(world1)
    assert card[1:] == cpu[1:]
    assert cpu[2] == [("sync/bucket_build", "error", 3, 0)]
    # the faulted build records no span
    assert cpu[1]["dispatch/fallback"] == 1 and cpu[1]["sync/bucket_build"] == cpu[3] - 1
    for got, want in zip(card[0], cpu[0]):
        for key in want:
            assert_bitwise(got[key], want[key], key)


def test_a_capture_holds_the_collector_off(monkeypatch):
    """A garbage collection inside a CUDA-graph capture can free another
    engine's graph (engines and metrics form reference cycles), whose
    destruction the capturing stream refuses: ``_capture`` holds Python's
    collector off for the capture, and gives it back whatever happens."""
    import gc

    from metrics_tpu_torch.utils.exceptions import Uncapturable

    seen = []

    class FakeGraph:
        pass

    class FakeCapture:
        fail = False

        def __init__(self, graph, pool=None, stream=None, capture_error_mode=None):
            pass

        def __enter__(self):
            seen.append(gc.isenabled())

        def __exit__(self, *exc):
            if FakeCapture.fail:
                raise RuntimeError("operation not permitted when stream is capturing")
            return False

    monkeypatch.setattr(tengine.torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(tengine.torch.cuda, "graph", FakeCapture)
    step = tengine.CapturedStep(lambda state, args, kwargs: {"x": state["x"] + 1}, writes_state=True)
    step.probe({"x": torch.zeros(3)}, (), {})  # the CPU's probe: statics, no capture
    step._capture(side=None)
    assert isinstance(step.graph, FakeGraph)
    FakeCapture.fail = True
    with pytest.raises(Uncapturable, match="capture refused"):
        step._capture(side=None)
    assert seen == [False, False] and gc.isenabled()


# --------------------------------------------------------------------------- #
# retry
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1, 42])
def test_backoff_sequences_equal_the_jax_packages(seed):
    kw = dict(backoff_base_s=0.01, backoff_multiplier=2.0, backoff_max_s=0.3, jitter=0.5, seed=seed)
    got_pol, want_pol = RetryPolicy(**kw), jretry.RetryPolicy(**kw)
    got_rng, want_rng = got_pol.rng(), want_pol.rng()
    got = [got_pol.backoff_for(k, got_rng) for k in range(1, 9)]
    want = [want_pol.backoff_for(k, want_rng) for k in range(1, 9)]
    assert got == want
    assert all(0.0 < d <= 0.3 for d in got)
    assert RetryPolicy(seed=seed) == RetryPolicy(seed=seed)


class _Flaky:
    def __init__(self, failures, err):
        self.failures, self.err, self.calls = failures, err, 0

    def __call__(self):
        self.calls += 1
        if self.calls <= self.failures:
            raise self.err
        return "ok"


@pytest.mark.parametrize("err", [
    OSError("flaky"), FileNotFoundError("gone"), PermissionError("no"), TimeoutError("slow"),
    ConnectionError("reset"), ValueError("bug"), "chaos_transient", "chaos_fatal",
])
def test_call_with_retry_matches_the_jax_packages(err):
    fast = dict(backoff_base_s=0.0, backoff_max_s=0.0, jitter=0.0, seed=0)
    results = []
    for retry, chaos in ((tretry, tchaos), (jretry, jchaos)):
        e = {"chaos_transient": chaos.ChaosError("storage/read", transient=True),
             "chaos_fatal": chaos.ChaosError("storage/read", transient=False)}.get(err, err)
        fn = _Flaky(2, e)
        try:
            out = retry.call_with_retry(fn, retry.RetryPolicy(**fast), op="read")
        except Exception as raised:  # noqa: BLE001 - the outcome is compared
            out = type(raised).__name__
        results.append((out, fn.calls, retry.default_classify(e)))
    assert results[0] == results[1]


def test_retry_ticks_the_registry_and_the_tracer():
    from metrics_tpu_torch.observability.instruments import REGISTRY

    before = REGISTRY.counter("checkpoint_retries_total", op="unit").value
    with tobs.trace() as tracer:
        assert call_with_retry(_Flaky(2, OSError("x")), RetryPolicy(backoff_base_s=0.0, jitter=0.0), op="unit") == "ok"
    assert REGISTRY.counter("checkpoint_retries_total", op="unit").value == before + 2
    assert [e.name for e in tracer.events()] == ["ckpt/retry", "ckpt/retry"]


# --------------------------------------------------------------------------- #
# the non-finite guard
# --------------------------------------------------------------------------- #
def _mse_stream():
    rng = np.random.default_rng(12)
    stream = [(rng.normal(size=32).astype(np.float32), rng.normal(size=32).astype(np.float32)) for _ in range(6)]
    poisoned = stream[3][0].copy()
    poisoned[5] = np.nan
    return stream, poisoned


@pytest.mark.parametrize("compiled", [True, False])
def test_quarantine_rolls_a_nan_batch_back_bit_for_bit(compiled):
    stream, poisoned = _mse_stream()
    clean = mt.MeanSquaredError(device="cpu", compiled_update=compiled)
    guarded = mt.MeanSquaredError(device="cpu", compiled_update=compiled)
    jax_guarded = mj.MeanSquaredError(compiled_update=compiled)
    for i, (p, t) in enumerate(stream):
        if i != 3:
            clean.update(torch.from_numpy(p), torch.from_numpy(t))
    with tobs.trace() as tracer:
        with tguard.guarded("quarantine"), jguard.guarded("quarantine"):
            for i, (p, t) in enumerate(stream):
                p = poisoned if i == 3 else p
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    guarded.update(torch.from_numpy(p), torch.from_numpy(t))
                    jax_guarded.update(jnp.asarray(p), jnp.asarray(t))
                assert any("quarantined" in str(w.message) for w in caught) == (i == 3)
    for key, value in clean.get_state().items():
        assert_bitwise(guarded.get_state()[key], value, key)
        np.testing.assert_allclose(guarded.get_state()[key].numpy(), np.asarray(jax_guarded.get_state()[key]),
                                   rtol=1e-6)
    assert guarded._update_count == clean._update_count == jax_guarded._update_count == 5
    trips = [e for e in tracer.events() if e.name == "guard/nonfinite"]
    assert [(e.args["where"], e.args["leaves"]) for e in trips] == [("update", ["sum_squared_error"])]


def test_raise_names_the_leaf_at_each_boundary(world1):
    m = mt.MeanSquaredError(device="cpu")
    with tguard.guarded("raise"):
        with pytest.raises(NonFiniteStateError) as exc:
            m.update(torch.tensor([float("inf")]), torch.tensor([0.0]))
    assert (exc.value.owner, exc.value.where, exc.value.leaves) == ("MeanSquaredError", "update", ["sum_squared_error"])
    s = mt.SumMetric(device="cpu")
    s.update(torch.tensor(1.0))
    s.set_state({"value": torch.tensor(float("nan"))})
    with tguard.guarded("raise"):
        with pytest.raises(NonFiniteStateError) as exc:
            s.sync(process_group=world1, distributed_available=lambda: True)
        assert exc.value.where == "sync" and exc.value.leaves == ["value"]
        with pytest.raises(NonFiniteStateError) as exc:
            s.compute()
        assert exc.value.where == "compute"
    assert tguard.guard_policy() is None


def test_nonfinite_leaves_equal_the_jax_packages():
    rng = np.random.default_rng(3)
    tree = {
        "ok": rng.normal(size=(4,)).astype(np.float32),
        "bad": np.array([1.0, np.nan], np.float32),
        "inf": np.array([[np.inf]], np.float64),
        "ints": np.zeros((2,), np.int32),
        "flags": np.zeros((2,), bool),
        "empty": np.zeros((0,), np.float32),
    }
    got = tguard.nonfinite_leaves({k: torch.from_numpy(v) for k, v in tree.items()})
    want = jguard.nonfinite_leaves({k: jnp.asarray(v) for k, v in tree.items()})
    assert got == want == ["bad", "inf"]
    assert tguard.nonfinite_leaves([torch.ones(2), torch.tensor([float("nan")])]) == ["leaf[1]"]
    assert tguard.nonfinite_leaves({"x": float("nan"), "y": 1.0}) == ["x"]


def test_the_guard_checks_nothing_inside_a_step():
    with tguard.guarded("raise"):
        with tengine._steady():
            assert tguard.capturing()
        assert not tguard.capturing()
        m = mt.MeanSquaredError(device="cpu")
        for _ in range(3):  # eager, probe, replay: checked at each facade boundary only
            m.update(torch.ones(4), torch.zeros(4))
    assert m._update_engine.stats.cache_hits == 1

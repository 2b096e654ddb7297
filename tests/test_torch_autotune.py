"""The port's self-tuning sync (``metrics_tpu_torch.autotune``) against the JAX package's.

Mirrors ``tests/autotune/`` case for case:

- the controller (``test_controller.py``): each unit case is a script of
  observations fed to both packages' controllers; the decision lists, the
  exported plans (as JSON, byte for byte), the transports, cadences and
  ladders must be equal, and a plan saved by either package pins the other;
- the sync integration (``test_sync_integration.py``): the port's eager
  syncs in one gloo world of 4 CPU ranks for the module
  (``tests/helpers/torch_autotune.py``, rank ``r`` holding the state times
  ``r + 1``) against the JAX loop that re-jits when the epoch moves, on 4
  of the 8 CPU devices. The port runs as many syncs as the JAX loop
  traced, so both observe alike: decisions and plans equal; synced values
  bit for bit (the float state holds multiples of 1/8, whose sums are exact
  in any order, and int8 sums integers); then further syncs, which the port
  observes and a jitted JAX loop does not, make no decision;
- the chaos safety floor (``test_safety_floor.py``) under the port's chaos:
  the port's own checks, since faults fire per sync here and per trace there;
- the port's own rules: a compiled step whose probe makes a decision
  captures the probe's transports and rebuilds at the next call; a
  collection's committed tuner and a pinned plan add no rebuild or capture.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import metrics_tpu as mt_jax
import metrics_tpu_torch as mt_torch
from metrics_tpu import autotune as jat
from metrics_tpu.autotune import controller as jat_controller
from metrics_tpu.autotune.controller import _BucketTuner as JaxTuner
from metrics_tpu.parallel import sync as jax_sync
from metrics_tpu_torch import autotune as pat
from metrics_tpu_torch.autotune import controller as pat_controller
from metrics_tpu_torch.autotune.controller import _BucketTuner as PortTuner
from metrics_tpu_torch.core.engine import _autotune_token
from metrics_tpu_torch.parallel import sync as port_sync
from tests.helpers import torch_autotune as ta
from tests.helpers import torch_dist as td
from tests.helpers.torch_port import assert_bitwise, one_torch_thread  # noqa: F401  (the module fixture)

try:
    from jax import shard_map  # jax >= 0.8
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WORLD = 4
UNIT_WORLD = 8  # the JAX unit tests' world; the controller reads it as a number

SIDES = {
    "jax": dict(at=jat, ctl=jat_controller, Tuner=JaxTuner, sync=jax_sync),
    "torch": dict(at=pat, ctl=pat_controller, Tuner=PortTuner, sync=port_sync),
}


@pytest.fixture(autouse=True)
def _reset():
    for side in SIDES.values():
        side["at"].set_autotune(False)
        side["sync"].set_sync_transport(None)
        side["sync"].set_sync_cadence(None)
    yield
    for side in SIDES.values():
        side["at"].set_autotune(None)
        side["sync"].set_sync_transport(None)
        side["sync"].set_sync_cadence(None)


# --------------------------------------------------------------------------- #
# the controller: scripted observations through both packages
# --------------------------------------------------------------------------- #
def _observe(side, ctl, red, dtype, times=1, *, nelems=8192, world=UNIT_WORLD, tolerance=None, refusal=None,
             error_scale=1.0, requested=None):
    """Feed ``times`` gate outcomes as ``_sync_bucketed`` reports them: the
    tuner's own proposal, admitted unless ``refusal`` is given."""
    dt = np.dtype(dtype)
    for _ in range(times):
        tuner = ctl.buckets.get(side["at"].bucket_key(red, dt))
        req = requested or (tuner.current if tuner else "exact")
        ctl.observe_bucket(red, dt, requested=req, transport="exact" if refusal else req, refusal=refusal,
                           nelems=nelems, world=world, tolerance=tolerance, error_scale=error_scale)


def _until_commit(side, ctl, red, dtype, **kw):
    key = side["at"].bucket_key(red, np.dtype(dtype))
    for _ in range(32):
        _observe(side, ctl, red, dtype, **kw)
        if ctl.buckets[key].phase == "committed":
            return
    raise AssertionError(f"{key} did not commit")


def _report(side, ctl):
    return {
        "decisions": ctl.decisions,
        "plan": ctl.export_plan().to_dict(),
        "buckets": {k: {"ladder": list(t.ladder()), "cadence": t.cadence, "committed": t.committed,
                        "tolerance_bf16": t.tolerance_for("bf16"), "cadence_for": [t._cadence_for(r) for r in
                                                                                   side["at"].LADDER]}
                    for k, t in ctl.buckets.items()},
        "cadence": ctl.cadence(),
    }


def _ctl(side, **config):
    return side["at"].AutotuneController(config=side["at"].PolicyConfig(**config))


def s_walk_commit(side):
    ctl = _ctl(side)
    _until_commit(side, ctl, "sum", "float32")
    return _report(side, ctl)


def s_ladders(side):
    ctl = _ctl(side)
    for red, dtype in (("sum", "float32"), ("max", "float32"), ("sum", "int32"), ("min", "float64")):
        _observe(side, ctl, red, dtype, nelems=2)
    _observe(side, ctl, "sum", "float64", nelems=64, world=1)
    return _report(side, ctl)


def s_tight_budget(side):
    ctl = _ctl(side, error_budget=1e-6)
    _observe(side, ctl, "sum", "float32", 4)
    return _report(side, ctl)


def s_zero_tolerance(side):
    ctl = _ctl(side)
    _observe(side, ctl, "sum", "float32", 4, tolerance=0.0)
    _observe(side, ctl, "sum", "int32", 6, nelems=1000, tolerance=0.0)
    return _report(side, ctl)


def s_budget_never_loosens(side):
    ctl = _ctl(side, error_budget=0.5)
    _observe(side, ctl, "sum", "float32", 4, tolerance=0.002)
    return _report(side, ctl)


def s_no_world(side):
    ctl = _ctl(side)
    _observe(side, ctl, "sum", "float32", 3, world=None)
    return _report(side, ctl)


def s_steady_state(side):
    """Committed, then 3 x min_dwell observations at unchanged parameters:
    no decision (what an eager loop feeds the tuner after the commit)."""
    ctl = _ctl(side)
    _until_commit(side, ctl, "sum", "float32")
    committed = len(ctl.decisions)
    _observe(side, ctl, "sum", "float32", 3 * ctl.config.min_dwell)
    assert len(ctl.decisions) == committed
    return _report(side, ctl)


def s_dwell_and_margin(side):
    ctl = _ctl(side, min_dwell=4, hysteresis=0.10)
    _until_commit(side, ctl, "sum", "float32", nelems=64)
    _observe(side, ctl, "sum", "float32", 8, nelems=8192)
    return _report(side, ctl)


def s_sub_margin(side):
    ctl = _ctl(side, min_dwell=2, hysteresis=0.60)
    _until_commit(side, ctl, "sum", "float32", nelems=64)
    _observe(side, ctl, "sum", "float32", 6, nelems=8192)
    return _report(side, ctl)


def s_refusal_poisons(side):
    ctl = _ctl(side)
    _observe(side, ctl, "sum", "float32")
    _observe(side, ctl, "sum", "float32", refusal={"reason": "error_budget", "bound": 1.0, "tolerance": 0.0})
    _until_commit(side, ctl, "sum", "float32")
    _observe(side, ctl, "sum", "float32", 3 * ctl.config.min_dwell)
    return _report(side, ctl)


def s_poison_all(side):
    ctl = _ctl(side)
    _until_commit(side, ctl, "sum", "float32")
    tuner = ctl.buckets[side["at"].bucket_key("sum", np.dtype("float32"))]
    for rung in ("bf16", "int8", "sparse_count"):
        tuner.poison(rung, "error_spike")
    return {**_report(side, ctl), "current": tuner.current}


def s_error_spike(side):
    ctl = _ctl(side)
    _until_commit(side, ctl, "sum", "float32")
    ctl.observe_error("sum", np.dtype("float32"), measured=1e-6)
    ctl.observe_error("sum", np.dtype("float32"), measured=0.5)
    ctl.observe_error("max", np.dtype("float32"), measured=0.5)
    return _report(side, ctl)


def s_cadence(side):
    ctl = _ctl(side, max_cadence=8)
    _until_commit(side, ctl, "sum", "float32", tolerance=0.2)
    _until_commit(side, ctl, "sum", "int32", nelems=8192)
    return _report(side, ctl)


def s_determinism(side):
    ctl = _ctl(side, min_dwell=2)
    for step in range(24):
        for red, dtype in (("sum", "float32"), ("sum", "int32"), ("max", "float32")):
            _observe(side, ctl, red, dtype, nelems=4096 if step < 12 else 8192)
    return _report(side, ctl)


def s_world_one(side):
    """The autotune test's buckets at a world of one (chip_smoke.py phase
    19(c)): 12 observations each."""
    ctl = _ctl(side)
    for _ in range(12):
        _observe(side, ctl, "sum", "float32", nelems=8192, world=1)
        _observe(side, ctl, "sum", "int32", nelems=1000, world=1)
        _observe(side, ctl, "max", "float32", nelems=2, world=1)
    return _report(side, ctl)


def s_reshard(side):
    ctl = _ctl(side)
    key = side["at"].bucket_key("reshard", np.dtype("float32"), "reshard")
    for _ in range(6):
        tuner = ctl.buckets.get(key)
        cur = tuner.current if tuner else "exact"
        ctl.observe_bucket("reshard", np.dtype("float32"), kind="reshard", requested=cur, transport=cur,
                           nelems=4096, world=UNIT_WORLD)
    return _report(side, ctl)


def s_pinned(side):
    plan = side["at"].TunedPlan(cadence=4, buckets={
        side["at"].bucket_key("sum", np.dtype("float32")): {"transport": "int8"},
        side["at"].bucket_key("sum", np.dtype("int32")): {"transport": "bf16"},
    })
    ctl = side["at"].AutotuneController(pinned=plan)
    _observe(side, ctl, "sum", "float32", 8, requested="int8")
    return {**_report(side, ctl), "transports": [ctl.transport_for("sum", np.dtype(d)) for d in
                                                 ("float32", "int32", "float64")]}


SCENARIOS = {name[2:]: fn for name, fn in sorted(globals().items()) if name.startswith("s_")}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_controller_scenarios_equal_the_jax_packages(scenario):
    got = json.dumps(SCENARIOS[scenario](SIDES["torch"]), sort_keys=True)
    want = json.dumps(SCENARIOS[scenario](SIDES["jax"]), sort_keys=True)
    assert got == want


def test_scenarios_cover_the_unit_contract():
    walk = SCENARIOS["walk_commit"](SIDES["torch"])
    assert [d["reason"] for d in walk["decisions"]] == ["explore", "explore", "commit"]
    assert walk["buckets"]["sum|float32|psum"]["committed"] == "int8"
    assert SCENARIOS["ladders"](SIDES["torch"])["buckets"]["max|float32|psum"]["ladder"] == ["exact"]
    dwell = SCENARIOS["dwell_and_margin"](SIDES["torch"])
    switched = [d for d in dwell["decisions"] if d["reason"] == "hysteresis"]
    assert len(switched) == 1 and switched[0]["to"] == "int8"
    assert not [d for d in SCENARIOS["sub_margin"](SIDES["torch"])["decisions"] if d["reason"] == "hysteresis"]
    poisoned = SCENARIOS["refusal_poisons"](SIDES["torch"])
    assert poisoned["decisions"][1]["reason"] == "poisoned:error_budget"
    assert "bf16" not in poisoned["buckets"]["sum|float32|psum"]["ladder"]
    assert SCENARIOS["poison_all"](SIDES["torch"])["current"] == "exact"
    assert SCENARIOS["no_world"](SIDES["torch"])["decisions"] == []
    assert SCENARIOS["pinned"](SIDES["torch"])["transports"] == ["int8", "bf16", "exact"]
    one = SCENARIOS["world_one"](SIDES["torch"])["buckets"]
    assert {k: (v["committed"], v["cadence"]) for k, v in one.items()} == {
        "sum|float32|psum": ("int8", 4), "sum|int32|psum": ("int8", 4), "max|float32|psum": ("exact", 16)}


def test_bucket_key_names_torch_and_numpy_dtypes_alike():
    for td_, nd in ((torch.int32, np.int32), (torch.float32, "float32"), (torch.bool, np.bool_),
                    (torch.float64, np.dtype("float64"))):
        assert pat.bucket_key("sum", td_) == pat.bucket_key("sum", nd) == jat.bucket_key("sum", nd)
    assert pat.bucket_key("sum", torch.int32) == "sum|int32|psum"
    assert pat.bucket_key("max", torch.float32, "reshard") == "reshard|float32|reshard"


def test_plans_cross_between_the_packages(tmp_path):
    plans = {name: SCENARIOS["determinism"](side)["plan"] for name, side in SIDES.items()}
    assert json.dumps(plans["torch"], sort_keys=True) == json.dumps(plans["jax"], sort_keys=True)
    paths = {}
    for name, side in SIDES.items():
        paths[name] = tmp_path / f"{name}.json"
        side["at"].TunedPlan.from_dict(plans[name]).save(str(paths[name]))
    assert paths["torch"].read_bytes() == paths["jax"].read_bytes()
    for reader, writer in (("torch", "jax"), ("jax", "torch")):
        side = SIDES[reader]
        loaded = side["at"].TunedPlan.load(str(paths[writer]))
        assert loaded.to_dict() == plans[writer]
        ctl = side["at"].AutotuneController(pinned=loaded)
        want = SIDES[writer]["at"].AutotuneController(pinned=SIDES[writer]["at"].TunedPlan.load(str(paths[writer])))
        for red, dtype in (("sum", "float32"), ("sum", "int32"), ("max", "float32"), ("mean", "float64")):
            assert ctl.transport_for(red, np.dtype(dtype)) == want.transport_for(red, np.dtype(dtype))
        assert ctl.cadence() == want.cadence()
    for side in SIDES.values():
        with pytest.raises(ValueError, match="version"):
            side["at"].TunedPlan.from_dict({"version": 99})
        with pytest.raises(ValueError, match="transport"):
            side["at"].TunedPlan.from_dict({"buckets": {"sum|float32|psum": {"transport": "zstd"}}})


def test_env_pins_a_plan_file_or_turns_tuning_on(tmp_path, monkeypatch):
    path = tmp_path / "plan.json"
    jat.TunedPlan.from_dict(SCENARIOS["determinism"](SIDES["jax"])["plan"]).save(str(path))
    for value, enabled, pinned in ((str(path), True, True), ("1", True, False), ("0", False, False)):
        monkeypatch.setenv("METRICS_TPU_AUTOTUNE", value)
        for side in SIDES.values():
            side["at"].set_autotune(None)
            ctl = side["ctl"].get_controller()
            assert side["at"].autotune_enabled() is enabled
            assert (ctl is not None) is enabled and (ctl is not None and ctl.pinned is not None) is pinned
            if pinned:
                assert ctl.pinned.to_dict() == jat.TunedPlan.load(str(path)).to_dict()
    monkeypatch.delenv("METRICS_TPU_AUTOTUNE")
    pat.set_autotune(None)
    assert not pat.autotune_enabled() and pat.get_controller() is None and pat.export_plan() is None


def test_set_autotune_resets_and_bumps_the_epoch():
    pat.set_autotune(True, config={"min_dwell": 3})
    ctl = pat.get_controller()
    assert ctl.config == pat.PolicyConfig(min_dwell=3)
    epoch = pat.decision_epoch()
    pat.set_autotune(True)
    assert pat.get_controller() is not ctl and pat.decision_epoch() == epoch + 1
    assert mt_torch.set_autotune is pat.set_autotune and mt_torch.export_tuned_plan is pat.export_plan
    assert mt_torch.TunedPlan is pat.TunedPlan and mt_torch.PolicyConfig is pat.PolicyConfig
    assert sorted(pat.__all__) == sorted(jat.__all__)


def test_decision_events_and_registry_series_equal_the_jax_packages():
    from metrics_tpu.observability import instruments as jinst
    from metrics_tpu.observability import tracer as jtracer
    from metrics_tpu_torch.observability import instruments as tinst
    from metrics_tpu_torch.observability import tracer as ttracer

    out = {}
    for name, side, inst, tracer in (("jax", SIDES["jax"], jinst, jtracer), ("torch", SIDES["torch"], tinst, ttracer)):
        inst.REGISTRY.clear()
        side["at"].set_autotune(True)
        ctl = side["ctl"].get_controller()
        with tracer.trace() as tr:
            _until_commit(side, ctl, "sum", "float32")
            ctl.observe_error("sum", np.dtype("float32"), measured=0.5)
        events = [e.args for e in tr.events() if e.name == "sync/tune_decision"]
        assert events == ctl.decisions
        # the epoch counts every decision and reset of the process (other tests' too)
        series = sorted((s.name, tuple(sorted(s.labels.items())), s.value) for s in inst.REGISTRY.samples()
                        if s.name.startswith("metrics_tpu_autotune") and s.name != "metrics_tpu_autotune_decision_epoch")
        out[name] = (json.dumps(events, sort_keys=True), series)
        inst.REGISTRY.clear()
    assert out["torch"] == out["jax"]


# --------------------------------------------------------------------------- #
# the sync layer: a gloo world of 4 against 4 of the 8 CPU devices
# --------------------------------------------------------------------------- #
_STATE = {
    "big": ((np.arange(8192) % 320) * 0.125 + 0.125).astype(np.float32),
    "counts": (np.arange(1000) % 7).astype(np.int32),
    "mx": np.asarray([7.0, 1.0], np.float32),
}
_REDS = {"big": "sum", "counts": "sum", "mx": "max"}
STEPS = 16


def _smap(fn):
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    kwargs = dict(mesh=mesh, in_specs=P("data"), out_specs=P("data"))
    try:
        return shard_map(fn, check_vma=False, **kwargs)
    except TypeError:  # pragma: no cover - pre-0.8 jax spells the flag check_rep
        return shard_map(fn, check_rep=False, **kwargs)


def _per_device(state):
    return {k: jnp.stack([jnp.asarray(v * (r + 1), v.dtype) for r in range(WORLD)]) for k, v in state.items()}


def _jax_fn(transports=None, tolerances=None):
    def body(s):
        local = jax.tree_util.tree_map(lambda x: x[0], s)
        out = jax_sync.sync_state(local, _REDS, "data", bucketed=True, transports=transports, tolerances=tolerances)
        return jax.tree_util.tree_map(lambda x: jnp.expand_dims(x, 0), out)

    return jax.jit(_smap(body))


def _jax_drive(steps, tolerances=None):
    """The JAX integration loop: re-jit when the epoch moves. Returns the
    last output, the traces, the decisions and the plan after the last trace."""
    per_dev = _per_device(_STATE)
    epoch, fn, traces, out = jat.decision_epoch(), _jax_fn(tolerances=tolerances), 1, None
    for _ in range(steps):
        if jat.decision_epoch() != epoch:
            epoch, fn, traces = jat.decision_epoch(), _jax_fn(tolerances=tolerances), traces + 1
        out = fn(per_dev)
    ctl = jat_controller.get_controller()
    return ({k: np.asarray(v[0]) for k, v in out.items()}, traces, json.dumps(ctl.decisions, sort_keys=True),
            json.dumps(ctl.export_plan().to_dict(), sort_keys=True))


@pytest.fixture(scope="module")
def jax_runs():
    """Every JAX reference of the module, the tuner reset between them."""
    runs = {}
    for name, tolerances in (("tuned", None), ("zero_tol", {"big": 0.0, "counts": 0.0})):
        jat.set_autotune(True)
        runs[name] = _jax_drive(STEPS, tolerances)
        if name == "tuned":
            runs["plan"] = jat.export_plan().to_dict()
    jat.set_autotune(runs["plan"])
    runs["pinned"] = _jax_drive(8)
    jat.set_autotune(False)
    out = _jax_fn(transports={k: "exact" for k in _STATE})(_per_device(_STATE))
    runs["exact"] = {k: np.asarray(v[0]) for k, v in out.items()}
    runs["stacked"] = {}
    for tenants in (2, 5):
        jat.set_autotune(True)
        states = {"acc": {"tp": jnp.zeros((tenants, 16), jnp.float32)},
                  "f1": {"tp": jnp.zeros((tenants, 16), jnp.float32), "count": jnp.zeros((tenants,), jnp.int32)}}
        reds = {"acc": {"tp": "sum"}, "f1": {"tp": "sum", "count": "sum"}}
        jax.make_jaxpr(lambda s: jax_sync.sync_stacked_states(s, reds, "data"), axis_env=[("data", WORLD)])(states)
        runs["stacked"][tenants] = {k: t.nelems for k, t in jat_controller.get_controller().buckets.items()}
    jat.set_autotune(None)
    return runs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = td.GlooWorld(WORLD, str(tmp_path_factory.mktemp("gloo")))
    yield w
    w.close()


def _rank0(world, body, *args):
    reports = world.run_all(body, *args)
    return reports[0], reports


def test_tuned_sync_converges_as_the_jax_package_and_then_stays(world, jax_runs):
    jax_out, traces, jax_decisions, jax_plan = jax_runs["tuned"]
    rep, reports = _rank0(world, ta.tuned_drive, _STATE, _REDS, traces, STEPS - traces)
    assert rep["decisions"] == jax_decisions and json.loads(rep["decisions"])
    assert rep["plan"] == jax_plan
    # further observations at unchanged parameters decide nothing (an eager loop's steady state)
    assert rep["decisions_after"] == rep["decisions"] and rep["epoch_after"] == rep["epoch"]
    buckets = rep["buckets"]
    assert buckets["sum|float32|psum"]["committed"] == "int8"
    assert buckets["max|float32|psum"]["committed"] == "exact"
    assert all(b["phase"] == "committed" for b in buckets.values())
    for name in _STATE:
        assert_bitwise(rep["out"][name], jax_out[name], msg=name)
        for other in reports[1:]:
            assert_bitwise(other["out"][name], rep["out"][name], msg=f"{name}: ranks disagree")
    exact = jax_runs["exact"]
    big = np.asarray(rep["out"]["big"], np.float64)
    assert np.max(np.abs(big - exact["big"])) / np.max(np.abs(exact["big"])) <= port_sync.default_tolerance("int8")
    assert_bitwise(rep["out"]["mx"], exact["mx"], msg="mx")


def test_decision_log_replays_bitwise(world, jax_runs):
    _, traces, jax_decisions, _ = jax_runs["tuned"]
    logs = [_rank0(world, ta.tuned_drive, _STATE, _REDS, traces)[0]["decisions"] for _ in range(2)]
    assert logs[0] == logs[1] == jax_decisions


def test_pinned_plans_cross_and_replay_without_a_decision(world, jax_runs):
    tuned, _ = _rank0(world, ta.tuned_drive, _STATE, _REDS, STEPS)
    port_plan = json.loads(tuned["plan"])
    for plan in (jax_runs["plan"], port_plan):  # the JAX package's plan pins the port, and the port's its own
        rep, _ = _rank0(world, ta.tuned_drive, _STATE, _REDS, 8, 0, None, None, plan)
        assert rep["pinned"] and rep["decisions_after"] == "[]" and rep["epoch_after"] == rep["epoch"]
        for name in _STATE:
            assert_bitwise(rep["out"][name], tuned["out"][name], msg=name)
            assert_bitwise(rep["out"][name], jax_runs["pinned"][0][name], msg=f"{name} (the JAX package's pin)")
    # the port's plan pins the JAX package alike
    jat.set_autotune(port_plan)
    ctl = jat_controller.get_controller()
    assert {k: ctl.transport_for(*k.split("|")[:2]) for k in port_plan["buckets"]} == {
        k: v["transport"] for k, v in jax_runs["plan"]["buckets"].items()}


def test_declaration_outranks_and_hides_the_bucket(world):
    rep, _ = _rank0(world, ta.tuned_drive, _STATE, _REDS, 1, 1, None, {"big": "bf16"})
    assert "bf16" in rep["bytes_by_transport"]
    assert "sum|float32|psum" not in rep["buckets"] and "sum|int32|psum" in rep["buckets"]


def test_zero_tolerance_buckets_stay_bitwise(world, jax_runs):
    jax_out, traces, jax_decisions, _ = jax_runs["zero_tol"]
    tol = {"big": 0.0, "counts": 0.0}
    rep, _ = _rank0(world, ta.tuned_drive, _STATE, _REDS, traces, STEPS - traces, tol)
    assert rep["decisions"] == jax_decisions
    assert all(r in ("exact", "sparse_count") for r in rep["buckets"]["sum|float32|psum"]["ladder"])
    for name in _STATE:
        assert_bitwise(rep["out"][name], jax_runs["exact"][name], msg=name)
        assert_bitwise(rep["out"][name], jax_out[name], msg=f"{name} (JAX)")


def test_cadence_precedence_switch_env_tuner(monkeypatch):
    cadences = {}
    for name, side in SIDES.items():
        side["at"].set_autotune(True)
        _until_commit(side, side["ctl"].get_controller(), "sum", "float32", tolerance=0.2)
        cadences[name] = side["ctl"].get_controller().cadence()
    assert cadences["torch"] == cadences["jax"] > 1
    tuned = cadences["torch"]
    assert port_sync.sync_cadence_default() == tuned
    monkeypatch.setenv("METRICS_TPU_SYNC_EVERY", "5")
    assert port_sync.sync_cadence_default() == 5
    port_sync.set_sync_cadence(3)
    assert port_sync.sync_cadence_default() == 3
    port_sync.set_sync_cadence(None)
    monkeypatch.delenv("METRICS_TPU_SYNC_EVERY")
    assert port_sync.sync_cadence_default() == tuned
    # an incremental carry takes the tuned cadence
    carry = port_sync.init_incremental({"n": torch.zeros(4, dtype=torch.int32)}, {"n": "sum"},
                                       modes={"n": "incremental"})
    assert carry.sync_every == tuned


def test_partition_token_moves_only_on_decisions():
    pat.set_autotune(False)
    assert pat.partition_token() == -1 == _autotune_token()
    pat.set_autotune(True)
    tok = pat.partition_token()
    assert tok == pat.decision_epoch() == _autotune_token()
    ctl = pat.get_controller()
    ctl.observe_bucket("sum", torch.float32, requested="exact", transport="exact", nelems=8192, world=UNIT_WORLD)
    assert pat.partition_token() > tok
    tok = pat.partition_token()
    pinned = pat.TunedPlan(buckets={"sum|float32|psum": {"transport": "bf16"}})
    pat.set_autotune(pinned)
    tok = pat.partition_token()
    pat.get_controller().observe_bucket("sum", torch.float32, requested="bf16", transport="bf16", nelems=8192,
                                        world=UNIT_WORLD)
    assert pat.partition_token() == tok  # pins add no rebuild


def test_incremental_emissions_resolve_through_the_tuner_and_quiet_syncs_observe_nothing(world):
    plan = {"buckets": {"sum|int32|psum": {"transport": "int8"}}, "cadence": 2}
    rep, _ = _rank0(world, ta.pinned_incremental, plan)
    # int8 at the first emissions; the compounded bound refuses it later, at a world of 4
    assert rep["track"] and rep["planned"][0] == [["hits"], "int8"] and rep["planned"][-1] == [["hits"], "exact"]
    assert "int8" in rep["transports"]
    assert rep["quiet_buckets"] == [] and rep["observations"] == {"sum|int32|psum": 1}


@pytest.mark.parametrize("tenants", [2, 5])
def test_stacked_buckets_tune_through_n_independent_keys(world, jax_runs, tenants):
    rep, _ = _rank0(world, ta.stacked_keys, tenants)
    assert rep == jax_runs["stacked"][tenants]
    assert rep == {"sum|float32|psum": 32 * tenants, "sum|int32|psum": tenants}


# --------------------------------------------------------------------------- #
# the safety floor under the port's chaos
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_never_pushes_past_the_gate(world, jax_runs, seed):
    rep, _ = _rank0(world, ta.chaos_floor, _STATE, _REDS, seed)
    assert rep["aborted"] > 0 and rep["fired"] >= rep["aborted"]  # chaos hit (latency and aborted builds)
    assert rep["bad"] == []
    assert all(b["phase"] == "committed" for b in rep["buckets"].values())
    assert rep["buckets"]["sum|float32|psum"]["committed"] == "int8"
    assert rep["buckets"]["max|float32|psum"]["committed"] == "exact"
    want = jax_runs["exact"]["big"]
    got = np.asarray(rep["out"]["big"], np.float64)
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) <= rep["tolerance"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_error_spikes_demote_to_lossless_and_stay(world, jax_runs, seed):
    rep, _ = _rank0(world, ta.error_spikes, _STATE, _REDS, seed)
    assert rep["committed_lossy"] == {"float32": True, "int32": True}
    for key in ("sum|float32|psum", "sum|int32|psum"):
        assert rep["buckets"][key]["current"] in ("exact", "sparse_count") and rep["buckets"][key]["poisoned"]
    assert "poisoned:error_spike" in rep["reasons"] and rep["quiet_after"] and rep["bad"] == []
    for name in _STATE:
        assert_bitwise(rep["out"][name], jax_runs["exact"][name], msg=name)


# --------------------------------------------------------------------------- #
# the engines: a probe's decision, a committed collection, a pinned plan
# --------------------------------------------------------------------------- #
def test_a_probe_that_decides_captures_its_own_transports(world):
    x = (np.random.default_rng(20).random(8192) * 3.0 + 0.1).astype(np.float32)
    rep, reports = _rank0(world, ta.probe_decides, x)
    exact, probe, after = rep["computes"]
    assert_bitwise(probe, exact, msg="the probe's compute")
    assert not np.array_equal(after, exact)  # the next call syncs bf16
    expected = x.astype(np.float64) * sum(r + 1 for r in range(WORLD))
    assert np.max(np.abs(after - expected)) / np.max(np.abs(expected)) <= port_sync.transport_error_bound("bf16", WORLD)
    (e0, e1), (p0, p1), (a0, a1) = rep["epochs"]
    assert e0 == e1 == p0 and p1 == p0 + 1 and a0 == a1 == p1  # the probe's observation moved the epoch
    assert [tuple(d) for d in rep["decisions"]] == [("exact", "bf16", "explore")]
    assert rep["now"] == "bf16"
    assert rep["tuned"] and all(t == "exact" for _, t in rep["tuned"])
    assert_bitwise(rep["body"], exact, msg="the captured body, run after the decision")
    assert rep["steps"] == 1 and tuple(rep["calls"]) == (2, 1, 0)  # the third call rebuilt: eager under the new epoch
    for other in reports[1:]:
        assert_bitwise(other["computes"][2], after, msg="ranks disagree")


def test_committed_collection_and_pinned_plan_add_no_rebuild(world):
    rng = np.random.default_rng(21)
    raw = rng.random((48, 64, 10), dtype=np.float32) + np.float32(1e-3)
    probs = (raw / raw.sum(-1, keepdims=True)).astype(np.float32)
    labels = rng.integers(0, 10, (48, 64), dtype=np.int32)
    rep, reports = _rank0(world, ta.collection_rounds, probs, labels, 6, 4)
    assert json.loads(rep["decisions"]) and not rep["fallbacks"]
    assert all(b["phase"] == "committed" for b in rep["buckets"].values())
    assert tuple(rep["moved"]) == (0, 0) and rep["after"] == rep["before"]
    assert rep["pinned_decisions"] == 0 and rep["pinned_moved"] == 0
    assert rep["pinned_snapshot"]["builds"] == 1 and rep["pinned_snapshot"]["captures"] == [1, 1]
    for got, want in zip(rep["replay"], rep["post"]):
        for key in want:
            for g, w in zip(np.atleast_1d(got[key]) if not isinstance(got[key], list) else got[key],
                            np.atleast_1d(want[key]) if not isinstance(want[key], list) else want[key]):
                assert_bitwise(g, w, msg=key)
    for other in reports[1:]:
        assert other["decisions"] == rep["decisions"]

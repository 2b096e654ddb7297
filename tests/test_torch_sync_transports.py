"""The port's quantized sync transports against the JAX package's.

Mirrors ``tests/core/test_sync_transports.py`` case for case. The port's side
runs in one gloo world of 4 CPU ranks for the module
(``tests/helpers/torch_dist.py``), rank ``r`` holding the state times
``r + 1``; the JAX side runs the same states on 4 of the 8 CPU devices
through ``shard_map``, every reference of the module in one jitted function
(the ``jax_refs`` fixture). Stated tolerances:

- ``exact``, ``int8`` and ``sparse_count`` (both branches) are bit for bit
  the JAX package's. The float sums hold multiples of 1/8, whose sums are
  exact in any order: gloo's ring adds an element's terms in another order
  than XLA's all-reduce.
- ``bf16`` is bit for bit in a world of one (each rank's group of one
  against a mesh of one device). In a world of 4 the two packages round the
  partial sums differently, so each must lie within
  ``transport_error_bound("bf16", 4)`` (0.0234) of the float64 sum, relative
  to the bucket's largest magnitude; the measured errors are printed.
- Plans, refusal records and wire/logical bytes equal the JAX package's key
  for key. The collective kinds match under the port's mapping: ``psum``,
  ``pmean``, ``pmax`` and ``pmin`` are an ``all_reduce``; the int8 payload,
  a ``psum`` in JAX, is an ``all_gather`` of int8; of sparse_count's two
  branches, which JAX's program holds both of, the port runs and counts one.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import metrics_tpu as mt_jax
import metrics_tpu_torch as mt_torch
from metrics_tpu.parallel import sync as jax_sync
from metrics_tpu_torch.parallel import sync as port_sync
from tests.helpers import torch_dist as td
from tests.helpers.torch_port import assert_bitwise, one_torch_thread  # noqa: F401  (the module fixture)

try:
    from jax import shard_map  # jax >= 0.8
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WORLD = 4

_STATE = {
    "fsum": (np.arange(50) * 0.75 + 0.125).astype(np.float32),
    "fsum2": np.asarray(3.5, np.float32),
    "counts": (np.arange(1000) % 7).astype(np.int32),
    "hits": np.asarray(3, np.int32),
    "mx": np.asarray([7.0, 1.0], np.float32),
    "gather": np.asarray([1.0, 2.0], np.float32),
}
_REDS = {"fsum": "sum", "fsum2": "sum", "counts": "sum", "hits": "sum", "mx": "max", "gather": None}
_NEARLY_EMPTY = np.zeros(400, np.int32)
_NEARLY_EMPTY[7], _NEARLY_EMPTY[200] = 3, 1
_DENSE = (np.arange(400) % 5 + 1).astype(np.int32)

# every sync the module holds against the JAX package: (state, reductions,
# transports, tolerances)
CASES = {
    "none": (_STATE, _REDS, None, None),
    "exact": (_STATE, _REDS, {name: "exact" for name in _STATE}, None),
    "bf16_floats": (_STATE, _REDS, {"fsum": "bf16", "fsum2": "bf16"}, None),
    "int8_floats": (_STATE, _REDS, {"fsum": "int8", "fsum2": "int8"}, None),
    "bf16_counts": (_STATE, _REDS, {"counts": "bf16", "hits": "bf16"}, None),
    "int8_counts": (_STATE, _REDS, {"counts": "int8", "hits": "int8"}, None),
    "sparse_empty": ({"s": _NEARLY_EMPTY}, {"s": "sum"}, {"s": "sparse_count"}, None),
    "sparse_dense": ({"s": _DENSE}, {"s": "sum"}, {"s": "sparse_count"}, None),
    "exact_empty": ({"s": _NEARLY_EMPTY}, {"s": "sum"}, None, None),
    "exact_dense": ({"s": _DENSE}, {"s": "sum"}, None, None),
    "refused": (_STATE, _REDS, {"fsum": "bf16"}, {"fsum": 0.001}),
}


def _rank_state(state, rank):
    return {k: np.asarray(v * (rank + 1), dtype=v.dtype) for k, v in state.items()}


def _smap(fn, n):
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))
    kwargs = dict(mesh=mesh, in_specs=P("data"), out_specs=P("data"))
    try:
        return shard_map(fn, check_vma=False, **kwargs)
    except TypeError:  # pragma: no cover - pre-0.8 jax spells the flag check_rep
        return shard_map(fn, check_rep=False, **kwargs)


def _jax_sync_all(cases, n):
    """Device 0's synced state of every case, in one jitted shard_map."""

    def body(stacked):
        out = {}
        for name, (_, reds, transports, tolerances) in cases.items():
            local = jax.tree_util.tree_map(lambda x: x[0], stacked[name])
            synced = jax_sync.sync_state(local, reds, "data", bucketed=True, transports=transports, tolerances=tolerances)
            out[name] = jax.tree_util.tree_map(lambda v: jnp.expand_dims(v, 0), synced)
        return out

    per_device = {name: {k: jnp.stack([jnp.asarray(_rank_state({k: v}, r)[k]) for r in range(n)]) for k, v in st.items()}
                  for name, (st, _, _, _) in cases.items()}
    out = jax.jit(_smap(body, n))(per_device)
    return {name: {k: np.asarray(v[0]) for k, v in st.items()} for name, st in out.items()}


@pytest.fixture(scope="module")
def jax_refs():
    return _jax_sync_all(CASES, WORLD)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = td.GlooWorld(WORLD, str(tmp_path_factory.mktemp("gloo")))
    yield w
    w.close()


@pytest.fixture(scope="module")
def port_runs(world):
    """Every case synced in the gloo world: rank 0's report per case (the
    ranks must agree, which is checked here)."""
    out = {}
    for name, (state, reds, transports, tolerances) in CASES.items():
        reports = world.run(td.transport_sync, [(_rank_state(state, r), reds, transports, tolerances)
                                                for r in range(WORLD)])
        for report in reports[1:]:
            for key, value in report["state"].items():
                assert_bitwise(value, reports[0]["state"][key], msg=f"{name}.{key}: ranks disagree")
        out[name] = reports[0]
    return out


@pytest.fixture(autouse=True)
def _exact_default():
    port_sync.set_sync_transport(None)
    jax_sync.set_sync_transport(None)
    yield
    port_sync.set_sync_transport(None)
    jax_sync.set_sync_transport(None)


def _rel_err(got, want):
    """Largest absolute error over the bucket's largest exact magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _float64_sum(state, names):
    return np.concatenate([sum(_rank_state(state, r)[n].astype(np.float64) for r in range(WORLD)).ravel() for n in names])


def _trace_box(reds, state, transports=None, tolerances=None):
    """The JAX package's trace-time count of one sync over 4 devices."""
    with jax_sync.count_collectives() as box:
        jax.make_jaxpr(
            lambda st: jax_sync.sync_state(st, reds, "data", bucketed=True, transports=transports, tolerances=tolerances),
            axis_env=[("data", WORLD)],
        )({k: jnp.asarray(v) for k, v in state.items()})
    return box


# ------------------------------------------------------------ exact parity ---
def test_exact_is_the_same_code_path(port_runs, jax_refs):
    """An explicit all-exact map runs the very collectives of no map, with
    bitwise equal results, and both equal the JAX package's bit for bit."""
    none, exact = port_runs["none"], port_runs["exact"]
    assert none["box"]["by_kind"] == exact["box"]["by_kind"] == {"all_reduce": 3, "all_gather": 1}
    assert none["box"]["bytes"] == exact["box"]["bytes"]
    for key in _STATE:
        assert_bitwise(exact["state"][key], none["state"][key], msg=key)
        assert_bitwise(none["state"][key], jax_refs["none"][key], msg=key)
        assert_bitwise(exact["state"][key], jax_refs["exact"][key], msg=key)


# ------------------------------------------------------- quantized parity ----
@pytest.mark.parametrize("transport", ["bf16", "int8"])
def test_quantized_error_within_declared_and_abstract_bound(port_runs, jax_refs, transport):
    got, ref = port_runs[f"{transport}_floats"]["state"], jax_refs[f"{transport}_floats"]
    bound = port_sync.transport_error_bound(transport, WORLD)
    assert bound <= port_sync.DEFAULT_TOLERANCES[transport]  # admitted, not refused
    want = _float64_sum(_STATE, ("fsum", "fsum2"))
    port_err = _rel_err(np.concatenate([got["fsum"].ravel(), got["fsum2"].ravel()]), want)
    jax_err = _rel_err(np.concatenate([ref["fsum"].ravel(), ref["fsum2"].ravel()]), want)
    print(f"{transport} at world {WORLD}: port error {port_err:.3e}, JAX error {jax_err:.3e}, bound {bound:.3e}")
    assert 0.0 < port_err <= bound and jax_err <= bound
    if transport == "int8":
        for key in ("fsum", "fsum2"):
            assert_bitwise(got[key], ref[key], msg=key)
    assert port_runs[f"{transport}_floats"]["box"]["refusals"] == []
    # untouched buckets stay bitwise
    for name in ("counts", "hits", "mx", "gather"):
        assert_bitwise(got[name], port_runs["none"]["state"][name], msg=name)
        assert_bitwise(got[name], ref[name], msg=name)


@pytest.mark.parametrize("transport", ["bf16", "int8"])
def test_integer_buckets_round_back_to_integers(port_runs, jax_refs, transport):
    got, ref = port_runs[f"{transport}_counts"]["state"], jax_refs[f"{transport}_counts"]
    for name in ("counts", "hits"):
        assert got[name].dtype == np.int32 == ref[name].dtype  # the dtype survives the round trip
        want = sum(_rank_state(_STATE, r)[name].astype(np.float64) for r in range(WORLD))
        assert _rel_err(got[name], want) <= port_sync.transport_error_bound(transport, WORLD)
        if transport == "int8":
            assert_bitwise(got[name], ref[name], msg=name)


def test_bf16_is_bitwise_in_a_world_of_one(world):
    """Each rank's group of one against a mesh of one device."""
    cases = {"bf16_floats": CASES["bf16_floats"], "bf16_counts": CASES["bf16_counts"]}
    refs = _jax_sync_all(cases, 1)
    for name, (state, reds, transports, tolerances) in cases.items():
        reports = world.run(td.transport_sync, [(state, reds, transports, tolerances, True)] * WORLD)
        for report in reports:
            assert report["box"]["by_kind"]["all_reduce"] >= 1
            for key in state:
                assert_bitwise(report["state"][key], refs[name][key], msg=f"{name}.{key}")


def test_sparse_count_is_lossless_both_branches(port_runs, jax_refs):
    for regime in ("empty", "dense"):
        got = port_runs[f"sparse_{regime}"]
        assert_bitwise(got["state"]["s"], port_runs[f"exact_{regime}"]["state"]["s"], msg=regime)
        assert_bitwise(got["state"]["s"], jax_refs[f"sparse_{regime}"]["s"], msg=regime)
    # the branch each took: the gather when every rank's nonzeros fit, else the dense all_reduce
    assert port_runs["sparse_empty"]["box"]["by_kind"] == {"all_reduce": 1, "all_gather": 1}
    assert port_runs["sparse_dense"]["box"]["by_kind"] == {"all_reduce": 2}
    assert "sparse_count_overflow" in port_runs["sparse_dense"]["box"]["bytes_by_transport"]


# ------------------------------------------------------------------- gate ----
def test_refusal_falls_back_bitwise_with_reason(port_runs, jax_refs):
    """A tolerance under the bound refuses the bucket: the same record as the
    JAX package's, and the bucket syncs exact, bitwise."""
    transports, tolerances = CASES["refused"][2:]
    jax_box = _trace_box(_REDS, _STATE, transports, tolerances)
    box = port_runs["refused"]["box"]
    assert len(box["refusals"]) == 1
    ref = box["refusals"][0]
    assert ref == jax_box["refusals"][0]
    assert ref["reason"] == "error_budget" and ref["transport"] == "bf16"
    assert ref["bound"] > ref["tolerance"] == 0.001 and "fsum" in ref["states"]
    assert "bf16" not in box["bytes_by_transport"]  # nothing crossed quantized
    for key in _STATE:
        assert_bitwise(port_runs["refused"]["state"][key], port_runs["none"]["state"][key], msg=key)
        assert_bitwise(port_runs["refused"]["state"][key], jax_refs["refused"][key], msg=key)


def _plans(state_np, reds, world, **kw):
    port = port_sync.transport_plan({k: torch.from_numpy(np.asarray(v)) for k, v in state_np.items()}, reds, world, **kw)
    jax_state = {k: jax.ShapeDtypeStruct(np.shape(v), np.asarray(v).dtype) for k, v in state_np.items()}
    return port, jax_sync.transport_plan(jax_state, reds, world, **kw)


def test_gate_refuses_at_wider_world():
    assert port_sync.transport_error_bound("bf16", 8) <= port_sync.DEFAULT_TOLERANCES["bf16"]
    assert port_sync.transport_error_bound("bf16", 16) > port_sync.DEFAULT_TOLERANCES["bf16"]
    state = {"fsum": np.zeros(50, np.float32)}
    for world in (4, 8, 16):
        port, ref = _plans(state, {"fsum": "sum"}, world, transports={"fsum": "bf16"})
        assert port == ref, world
    port8, _ = _plans(state, {"fsum": "sum"}, 8, transports={"fsum": "bf16"})
    port16, _ = _plans(state, {"fsum": "sum"}, 16, transports={"fsum": "bf16"})
    assert port8[0]["transport"] == "bf16" and port8[0]["refusal"] is None
    assert port16[0]["transport"] == "exact" and port16[0]["refusal"]["reason"] == "error_budget"


def test_gate_routes_inapplicable_combinations_silently(world):
    """A global bf16 switch refuses nothing: the sum buckets go bf16, the max
    and gather buckets exact."""
    reports = world.run(td.transport_sync, [(_rank_state(_STATE, r), _REDS, None, None, False, "bf16")
                                            for r in range(WORLD)])
    jax_sync.set_sync_transport("bf16")
    jax_box = _trace_box(_REDS, _STATE)
    for report in reports:
        assert report["box"]["refusals"] == [] == jax_box["refusals"]
        assert set(report["box"]["bytes_by_transport"]) == set(jax_box["bytes_by_transport"]) == {"bf16", "exact"}


def test_sparse_count_needs_a_byte_win():
    port, ref = _plans({"c": np.zeros(2, np.int32)}, {"c": "sum"}, 8, transports={"c": "sparse_count"})
    assert port == ref
    assert port[0]["transport"] == "exact" and port[0]["refusal"]["reason"] == "no_byte_win"


@pytest.mark.parametrize("transport", port_sync.TRANSPORTS)
@pytest.mark.parametrize("kind", ["psum", "reshard"])
def test_error_bound_and_wire_bytes_equal_the_jax_packages(transport, kind):
    for world in (1, 2, 4, 8, 16, 64):
        assert port_sync.transport_error_bound(transport, world, kind) == jax_sync.transport_error_bound(transport, world, kind)
    for n in (0, 1, 255, 256, 1000, 1 << 20):
        for dtype in ("float32", "int32", "int64", "float64"):
            assert port_sync.transport_wire_bytes(transport, n, dtype) == jax_sync.transport_wire_bytes(transport, n, np.dtype(dtype))
    assert port_sync.default_tolerance(transport) == jax_sync.default_tolerance(transport)


def test_plan_of_a_mixed_state_equals_the_jax_packages():
    state = dict(_STATE, big=np.zeros((64, 64), np.int32), f64=np.zeros(7, np.float64))
    reds = dict(_REDS, big="sum", f64="sum")
    transports = {"fsum": "int8", "counts": "sparse_count", "big": "sparse_count", "f64": "bf16", "mx": "int8"}
    for world in (1, 4, 32):
        for scale in (1.0, 3.0):
            port, ref = _plans(state, reds, world, transports=transports, tolerances={"fsum": 0.02},
                               error_scale=scale)
            assert port == ref, (world, scale)


# ----------------------------------------------------------- wire accounting -
_COUNTS = {"counts": (np.arange(1000) % 7).astype(np.int32)}


def test_wire_vs_logical_byte_accounting(world):
    logical = 1000 * 4
    boxes = {}
    for transport in port_sync.TRANSPORTS:
        reports = world.run(td.transport_sync, [(_COUNTS, {"counts": "sum"}, {"counts": transport})] * WORLD)
        boxes[transport] = reports[0]["box"]
        jax_box = _trace_box({"counts": "sum"}, _COUNTS, {"counts": transport})
        if transport == "sparse_count":
            # 6 of 7 entries are nonzero: past K = 250, the dense branch ran
            assert boxes[transport]["by_kind"] == {"all_reduce": 2}
            assert jax_box["by_kind"] == {"pmax": 1, "all_gather": 1, "psum": 1}
            assert boxes[transport]["bytes_by_transport"]["sparse_count_overflow"] == \
                jax_box["bytes_by_transport"]["sparse_count_overflow"]
            assert boxes[transport]["bytes_by_transport"]["sparse_count"] == {"wire": 4, "logical": 0}
            continue
        assert boxes[transport]["bytes_by_transport"] == jax_box["bytes_by_transport"], transport
        want = {"psum": "all_reduce", "pmax": "all_reduce"}
        kinds = {}
        for kind, n in jax_box["by_kind"].items():
            # the int8 payload: a psum in JAX, an all_gather of int8 here
            port_kind = "all_gather" if (transport == "int8" and kind == "psum") else want.get(kind, kind)
            kinds[port_kind] = kinds.get(port_kind, 0) + n
        assert boxes[transport]["by_kind"] == kinds, transport
    assert boxes["exact"]["bytes_by_transport"] == {"exact": {"wire": logical, "logical": logical}}
    assert boxes["bf16"]["bytes_by_transport"]["bf16"]["wire"] * 2 == logical
    assert logical / boxes["int8"]["bytes_by_transport"]["int8"]["wire"] >= 3.5


def test_sparse_gather_bytes_equal_the_jax_packages(port_runs):
    jax_box = _trace_box({"s": "sum"}, {"s": _NEARLY_EMPTY}, {"s": "sparse_count"})
    assert port_runs["sparse_empty"]["box"]["bytes_by_transport"] == {"sparse_count": jax_box["bytes_by_transport"]["sparse_count"]}


# --------------------------------------------------------------- selection ---
def test_selection_precedence_and_validation(monkeypatch):
    assert port_sync.sync_transport_default() == jax_sync.sync_transport_default() == "exact"
    monkeypatch.setenv("METRICS_TPU_SYNC_TRANSPORT", "bf16")
    assert port_sync.sync_transport_default() == "bf16"
    mt_torch.set_sync_transport("int8")  # the global switch beats the environment
    assert port_sync.sync_transport_default() == "int8"
    # a per-state declaration beats the global switch
    assert port_sync._resolve_transport("a", {"a": "exact"}) == "exact"
    assert port_sync._resolve_transport("b", {"a": "exact"}) == "int8"
    mt_torch.set_sync_transport(None)
    assert port_sync.sync_transport_default() == "bf16"  # back to the environment
    monkeypatch.setenv("METRICS_TPU_SYNC_TRANSPORT", "bogus")
    assert port_sync.sync_transport_default() == "exact"  # an unknown value is ignored
    with pytest.raises(ValueError, match="unknown sync transport"):
        mt_torch.set_sync_transport("fp4")
    with pytest.raises(ValueError, match="unknown sync transport 'float4'"):
        port_sync._resolve_transport("x", {"x": "float4"})
    for t in port_sync.TRANSPORTS:
        mt_torch.set_sync_transport(t)
        assert port_sync.sync_transport_default() == t
    assert port_sync.TRANSPORTS == jax_sync.TRANSPORTS and port_sync.DEFAULT_TOLERANCES == jax_sync.DEFAULT_TOLERANCES
    assert (port_sync.INT8_BLOCK, port_sync.SPARSE_COUNT_DENSITY) == (jax_sync.INT8_BLOCK, jax_sync.SPARSE_COUNT_DENSITY)


def test_add_state_declarations_validate():
    class _M(mt_torch.Metric):
        full_state_update = False

        def __init__(self, **kw):
            super().__init__(device="cpu")
            self.add_state("total", torch.zeros(4), dist_reduce_fx="sum", **kw)

        def update(self, x):
            self.total = self.total + x

        def compute(self):
            return self.total

    m = _M(sync_transport="bf16", sync_tolerance=0.04)
    assert m.sync_transports == {"total": "bf16"}
    assert m.sync_tolerances == {"total": 0.04}
    assert _M().sync_transports == {}
    with pytest.raises(ValueError, match="sync_transport"):
        _M(sync_transport="fp4")
    with pytest.raises(ValueError, match="sync_tolerance"):
        _M(sync_transport="bf16", sync_tolerance=-0.1)


# ------------------------------------------------------- metric integration --
class _JaxQuantMetric(mt_jax.Metric):
    full_state_update = False

    def __init__(self, transport=None):
        super().__init__(compiled_compute=False)
        kw = {"sync_transport": transport} if transport is not None else {}
        self.add_state("total", jnp.zeros((32,), jnp.float32), dist_reduce_fx="sum", **kw)
        self.add_state("n", jnp.zeros((), jnp.float32), dist_reduce_fx="sum")

    def update(self, x):
        self.total = self.total + x
        self.n = self.n + 1.0

    def compute(self):
        return self.total / jnp.maximum(self.n, 1.0)


def test_metric_and_collection_sync_states_honor_declarations(world):
    """``Metric.sync_states`` and ``MetricCollection.sync_states`` (the
    entry collection, every state declared int8) against the JAX package's
    on the same rank inputs: int8 bitwise, and the undeclared state
    bitwise."""
    from __graft_entry__ import _make_collection

    rng = np.random.default_rng(5)
    xs = (rng.integers(4, 17, (WORLD, 32)) / 8).astype(np.float32)  # multiples of 1/8: exact sums
    logits = rng.normal(size=(WORLD, 16, td.C)).astype(np.float32)
    target = rng.integers(0, td.C, (WORLD, 16)).astype(np.int64)
    reports = {t: world.run(td.declared_sync, [(xs[r], t, (logits[r], target[r])) for r in range(WORLD)])
               for t in (None, "int8")}
    jax_coll = _make_collection(td.C)

    def body(x, lg, tg):
        out = {}
        for t in (None, "int8"):
            m = _JaxQuantMetric(t)
            out[f"metric_{t}"] = m.sync_states(m.update_state(m.init_state(), x[0]), "data")
            for member in jax_coll._metrics.values():
                member._sync_transports = {n: t for n in member._defaults} if t else {}
            out[f"coll_{t}"] = jax_coll.sync_states(jax_coll.update_state(jax_coll.init_state(), lg[0], tg[0]), "data")
        return jax.tree_util.tree_map(lambda v: jnp.expand_dims(v, 0), out)

    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    kw = dict(mesh=mesh, in_specs=(P("data"),) * 3, out_specs=P("data"))
    try:
        f = shard_map(body, check_vma=False, **kw)
    except TypeError:  # pragma: no cover
        f = shard_map(body, check_rep=False, **kw)
    ref = jax.tree_util.tree_map(lambda v: np.asarray(v[0]), jax.jit(f)(xs, logits, target))
    for t in (None, "int8"):
        for report in reports[t]:
            for name in ("total", "n"):
                assert_bitwise(report["metric"][name], ref[f"metric_{t}"][name], msg=f"{t} {name}")
            for leader, states in report["collection"].items():
                for name, value in states.items():
                    assert_bitwise(value, ref[f"coll_{t}"][leader][name], msg=f"{t} {leader}.{name}")
    got, want = reports["int8"][0]["metric"]["total"], reports[None][0]["metric"]["total"]
    assert 0.0 < _rel_err(got, want) <= port_sync.transport_error_bound("int8", WORLD)
    assert reports["int8"][0]["box"]["by_kind"] == {"all_reduce": 2, "all_gather": 1}  # n stays exact, apart
    coll_int8 = reports["int8"][0]["coll_box"]["bytes_by_transport"]
    assert set(coll_int8) == {"int8"}  # every bucket of the collection crossed as int8


def test_transport_is_config_not_state():
    """State dicts interchange across declarations: the transport never
    reaches the state."""
    a, b = td.QuantMetric("int8", 0.05), td.QuantMetric()
    a.persistent(True)
    b.persistent(True)
    a.update(torch.full((32,), 2.0))
    b.load_state_dict(a.state_dict())
    for name in ("total", "n"):
        assert_bitwise(a.get_state()[name], b.get_state()[name], msg=name)
    a.load_state_dict(b.state_dict())
    assert a.sync_transports == {"total": "int8"} and b.sync_transports == {}
    assert set(a.state_dict()) == {"total", "n"}

"""The port's sharded state against the JAX package's.

Mirrors ``tests/core/test_sharded_state.py`` case for case, apart from the
checkpoint cases, which wait for the port's checkpoint module. The port's
side runs in one gloo world of 4 CPU ranks for the module
(``tests/helpers/torch_dist.py``; the rank bodies are in
``tests/helpers/torch_shard.py``): rank ``r`` updates with the ``r``-th
quarter of every global batch, made with ``np.random.default_rng``. The JAX
side, computed once for the module (``jax_refs``), runs the whole batches
through the JAX metric placed over ``make_mesh([4], ["data"])`` on 4 of the
8 CPU devices, whose blocks come from ``addressable_shards``, and through the
replicated JAX metric. Stated tolerances:

- every rank's block equals the JAX package's block of that rank bit for
  bit, and the integer and elementwise computes equal the JAX replicated
  compute bit for bit; macro Precision, which sums over the sharded class
  axis, within rtol = atol = 1e-6 (``_leaves_equal`` of the JAX tests);
- counts are the port's own where its ``compute()`` really syncs: a placed
  metric's compute gathers its result (``"all_gather"``), which the JAX
  package's single-controller facade does not tick, and each update runs
  one ``reduce_scatter`` per ``(dtype, shard dimension)`` bucket, which the
  JAX package leaves to GSPMD. Each test states the port's count.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import metrics_tpu as mt_jax
from metrics_tpu.parallel import make_mesh as jax_make_mesh
from metrics_tpu.parallel import mesh as jax_mesh
from metrics_tpu_torch.parallel import mesh as port_mesh
from tests.helpers import torch_dist as td
from tests.helpers import torch_shard as ts
from tests.helpers.torch_port import assert_bitwise, assert_close, one_torch_thread  # noqa: F401  (the module fixture)

pytestmark = [pytest.mark.usefixtures("one_torch_thread"), pytest.mark.filterwarnings("ignore")]

WORLD = 4


def _split(batches):
    """Each rank's quarter of every global batch, rank-major."""
    return [[tuple(np.array_split(x, WORLD)[r] for x in batch) for batch in batches] for r in range(WORLD)]


def _confmat_case():
    rng = np.random.default_rng(0)
    data = [(rng.integers(0, 64, 128), rng.integers(0, 64, 128)) for _ in range(3)]
    return ("ConfusionMatrix", {"num_classes": 64}), data, True


def _precision_case():
    rng = np.random.default_rng(0)
    data = [(rng.random((64, 16), dtype=np.float32), rng.integers(0, 16, 64)) for _ in range(3)]
    return ("Precision", {"num_classes": 16, "average": "macro"}), data, False


def _binned_case():
    rng = np.random.default_rng(0)
    data = [(rng.random((32, 16), dtype=np.float32), rng.integers(0, 2, (32, 16))) for _ in range(3)]
    return ("BinnedPrecisionRecallCurve", {"num_classes": 16, "thresholds": 10}), data, True


def _catbuffer_case():
    data = [(np.arange(i * 8, i * 8 + 8, dtype=np.float32),) for i in range(4)]
    return ("CatMetric", {"buffer_capacity": 64}), data, True


CASES = {"confmat": _confmat_case, "precision_macro": _precision_case, "binned_pr": _binned_case,
         "catbuffer": _catbuffer_case}


def _jax_metric(spec):
    cls, kwargs = spec
    return getattr(mt_jax, cls)(**kwargs)


def _jax_blocks(leaf):
    data = leaf.data if isinstance(leaf, mt_jax.CatBuffer) else leaf
    shards = sorted(data.addressable_shards, key=lambda s: s.index[0].start or 0)
    return [np.asarray(s.data) for s in shards]


@pytest.fixture(scope="module")
def jax_refs():
    mesh = jax_make_mesh([WORLD], ["data"], jax.devices()[:WORLD])
    out = {"parity": {}}
    for key, case in CASES.items():
        spec, data, _ = case()
        ref = _jax_metric(spec)
        placed = _jax_metric(spec).shard_state(mesh)
        for batch in data:
            ref.update(*map(jnp.asarray, batch))
            placed.update(*map(jnp.asarray, batch))
        state = placed.metric_state
        out["parity"][key] = {
            "value": jax.tree_util.tree_map(np.asarray, ref.compute()),
            "blocks": {name: _jax_blocks(state[name]) for name in placed.shard_axes},
        }
    try:
        mt_jax.ConfusionMatrix(num_classes=10).shard_state(mesh)
        out["uneven"] = "no error"
    except ValueError as err:
        out["uneven"] = str(err)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = td.GlooWorld(WORLD, str(tmp_path_factory.mktemp("gloo")))
    yield w
    w.close()


# --------------------------------------------------------------------------- #
# declaration surface
# --------------------------------------------------------------------------- #
def test_add_state_shard_axis_validation():
    import torch

    import metrics_tpu_torch as mt

    class Bad(mt.Metric):
        def __init__(self, default, shard_axis, **kw):
            super().__init__(device="cpu", **kw)
            red = "cat" if isinstance(default, mt.CatBuffer) else "sum"
            self.add_state("s", default=default, dist_reduce_fx=red, shard_axis=shard_axis)

        def update(self):
            pass

        def compute(self):
            return self.s

    with pytest.raises(ValueError, match="must be an int"):
        Bad(torch.zeros(4), "0")
    with pytest.raises(ValueError, match="scalar states"):
        Bad(torch.tensor(0.0), 0)
    with pytest.raises(ValueError, match="out of range"):
        Bad(torch.zeros(4), 2)
    with pytest.raises(ValueError, match="unbounded list states"):
        Bad([], 0)
    with pytest.raises(ValueError, match="sample axis only"):
        Bad(mt.CatBuffer.empty(8), 1)
    assert Bad(torch.zeros((2, 3)), -1).shard_axes == {"s": -1}


def test_declaration_is_inert(world):
    spec = ("GridMetric", {"shape": (4, 6)})
    for report in world.run_all(ts.sync_counts, spec, False):
        assert report["shard_axes"] == {"grid": (0, 1)} and report["active"] == {}
        assert report["box"]["by_kind"] == {"all_reduce": 1}  # a psum bucket, no reshard


@pytest.fixture(scope="module")
def placement_errors(world):
    return world.run_all(ts.placement_errors)


def test_shard_state_requires_known_axis(placement_errors):
    for report in placement_errors:
        assert report["unknown_axis"].startswith("ValueError") and "axis" in report["unknown_axis"]


def test_shard_state_without_declarations_warns(placement_errors):
    assert any("shard_axis" in w for w in placement_errors[0]["warned"])  # rank_zero_warn: rank 0 only


def test_shard_state_refuses_an_uneven_dimension(placement_errors, jax_refs):
    """A dimension the mesh width does not divide raises ValueError in both
    packages: the JAX package's device_put refuses it under jax 0.9, whatever
    its docstring says about padding; the port does not pad either."""
    assert "divisible" in jax_refs["uneven"]
    for report in placement_errors:
        assert report["uneven"].startswith("ValueError") and "does not divide" in report["uneven"]


def test_shard_state_refuses_other_reductions(placement_errors):
    for report in placement_errors:
        assert report["mean_leaf"].startswith("NotImplementedError") and "'peak'" in report["mean_leaf"]


def test_max_leaf_merges_by_max(world):
    rng = np.random.default_rng(3)
    data = [(rng.standard_normal((8, 3)).astype(np.float32),) for _ in range(WORLD * 2)]
    per_rank = [[data[2 * r], data[2 * r + 1]] for r in range(WORLD)]
    want = np.maximum(np.max(np.stack([d[0] for d in data]), axis=0), -1.0)
    for report in world.run(ts.stream, [(("MaxGrid", {}), b) for b in per_rank]):
        assert all(u["by_kind"] == {"reduce_scatter": 1} for u in report["updates"])
        assert_bitwise(report["value"], want)


def test_placement_specs_match_the_jax_package():
    jmesh = jax_make_mesh([1, 1, 1], ["data", "cls", "thr"], jax.devices()[:1])
    cases = [
        ("replicated", (), {}),
        ("batch_sharded", ("cls",), {}),
        ("class_sharded", ("cls",), {}),
        ("class_sharded", ("cls",), {"shard_axis": 1, "ndim": 3}),
        ("sample_sharded", ("thr",), {}),
        ("grid_sharded", (("cls", "thr"), (0, 1), 2), {}),
        ("grid_sharded", (("cls", "thr"), (1, 0), 3), {}),
        ("grid_sharded", (("cls", "thr"), (1,), 2), {}),
        ("shard_spec", (None, 2), {}),
        ("shard_spec", (0, 2), {}),
        ("shard_spec", (-1, 3), {"axis_name": ("thr", "cls")}),
        ("shard_spec", ((1, 0), 2), {"axis_name": ("cls", "thr")}),
    ]
    for fn, args, kwargs in cases:
        want = getattr(jax_mesh, fn)(jmesh, *args, **kwargs).spec
        got = getattr(port_mesh, fn)(object(), *args, **kwargs).spec
        assert got == tuple(want), (fn, args, kwargs)
    assert tuple(P("data", None)) == ("data", None)
    with pytest.raises(ValueError):
        port_mesh.grid_sharded(object(), ("cls",), (0, 1), 2)


# --------------------------------------------------------------------------- #
# parity: blocks and values against the JAX package
# --------------------------------------------------------------------------- #
def _assert_tree(got, want, exact, msg):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), msg
        for g, w in zip(got, want):
            _assert_tree(g, w, exact, msg)
    elif exact:
        assert_bitwise(got, want, msg=msg)
    else:
        assert_close(got, want, rtol=1e-6, atol=1e-6, msg=msg)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_parity_and_footprint(world, jax_refs, case):
    spec, data, exact = CASES[case]()
    want = jax_refs["parity"][case]
    reports = world.run(ts.stream, [(spec, batches) for batches in _split(data)])
    for rank, report in enumerate(reports):
        assert report["active"] and set(report["active"]) == set(want["blocks"])
        for name, blocks in want["blocks"].items():
            assert_bitwise(report["blocks"][name], blocks[rank], msg=f"{case} {name} rank {rank}")
            assert report["block_nbytes"][name] * WORLD == sum(b.nbytes for b in blocks)
        _assert_tree(report["value"], want["value"], exact, case)
        if case != "catbuffer":
            # one reduce_scatter per (dtype, shard dimension) bucket, every update
            assert all(u["by_kind"] == {"reduce_scatter": 1} for u in report["updates"]), report["updates"]
            assert report["compute"]["by_kind"].get("reshard", 0) == 0
        else:
            # the sample-sharded update: a shape exchange, then one gather of the rows
            assert all(u["by_kind"] == {"size_exchange": 1, "all_gather": 1} for u in report["updates"])
            assert "update:CatMetric" in report["fallback_reasons"]
            assert "host" in report["fallback_reasons"]["update:CatMetric"]


def test_sharded_update_uses_compiled_donated_engine(world):
    rng = np.random.default_rng(0)
    data = [(rng.integers(0, 64, 64), rng.integers(0, 64, 64)) for _ in range(5)]
    args = [(("ConfusionMatrix", {"num_classes": 64}), b, True, None, "data", False) for b in _split(data)]
    for report in world.run(ts.stream, args):
        engine = report["engine"]
        assert engine["compiled_calls"] > 0 and engine["donated_calls"] > 0
        assert engine["collective_counts"] == {"reduce_scatter": 1}  # the captured step's own collective
        assert not report["fallback_reasons"]
        assert all(u["by_kind"] == {"reduce_scatter": 1} for u in report["updates"])


# --------------------------------------------------------------------------- #
# sync routing: sharded leaves never all_reduce
# --------------------------------------------------------------------------- #
def test_sharded_leaves_spend_zero_reduce_bytes(world):
    for report in world.run_all(ts.sync_counts, ("ConfusionMatrix", {"num_classes": 64}), True):
        box = report["box"]
        assert box["by_kind"] == {"reshard": 1}
        # the port ticks the block it hands over (16 of 64 rows): the JAX
        # test hands its trace a whole-size block and ticks 64 x 64 x 4
        assert box["bytes_by_kind"] == {"reshard": 16 * 64 * 4}


def test_mixed_state_splits_buckets(world):
    """Micro Accuracy's scalars keep their all_reduce bucket; macro F1's leaves
    reshard (F1 declares no sharded compute of its own)."""
    f1 = world.run_all(ts.sync_counts, ("F1Score", {"num_classes": 16, "average": "macro"}), True)
    acc = world.run_all(ts.sync_counts, ("Accuracy", {"num_classes": 16, "average": "micro"}), True)
    for a, f in zip(acc, f1):
        assert f["box"]["by_kind"].get("reshard", 0) >= 1
        assert a["box"]["by_kind"].get("reshard", 0) == 0 and a["box"]["by_kind"].get("all_reduce", 0) >= 1


# --------------------------------------------------------------------------- #
# lifecycle: reset / state_dict / unshard
# --------------------------------------------------------------------------- #
def _lifecycle_batch():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 64, 128), rng.integers(0, 64, 128))


@pytest.fixture(scope="module")
def lifecycle(world):
    batch = _lifecycle_batch()
    ref = mt_jax.ConfusionMatrix(num_classes=64)
    ref.update(*map(jnp.asarray, batch))
    reports = world.run(ts.lifecycle, [(("ConfusionMatrix", {"num_classes": 64}), b[0]) for b in _split([batch])])
    return np.asarray(ref.compute()), reports


def test_reset_keeps_placement(lifecycle):
    _, reports = lifecycle
    for report in reports:
        assert report["reset_shapes"] == {"confmat": (16, 64)} and report["reset_sums"] == {"confmat": 0.0}
        assert report["reset_active"] == {"confmat": 0}


def test_state_dict_roundtrip_keeps_placement(lifecycle):
    want, reports = lifecycle
    for report in reports:
        assert_bitwise(report["before"], want)
        assert_bitwise(report["loaded"], want)
        assert report["loaded_shapes"] == report["block_shapes"] == {"confmat": (16, 64)}


def test_unshard_state(lifecycle):
    want, reports = lifecycle
    for report in reports:
        assert_bitwise(report["twice"], 2 * want)  # the loaded copy, updated once more
        assert report["unsharded_active"] == {} and report["unsharded_shapes"] == {"confmat": (64, 64)}
        assert_bitwise(report["after_unshard"], 2 * want)


@pytest.fixture(scope="module")
def catbuffer(world):
    return world.run_all(ts.catbuffer_cases, 4, 16)


def test_unshard_round_trip_reshard_accounting(lifecycle, catbuffer):
    """unshard_state bills one reshard per leaf at the whole leaf's bytes
    (64 x 64 int32; CatMetric's 16 float32 rows). The compute before it
    gathers its result, one "all_gather" (the port's own tick: the JAX
    facade's GSPMD compute ticks nothing)."""
    for report in lifecycle[1]:
        assert report["compute_unshard"]["by_kind"] == {"all_gather": 1, "reshard": 1}
        assert report["compute_unshard"]["bytes_by_kind"]["reshard"] == 64 * 64 * 4
    for report in catbuffer:
        assert report["unshard"]["by_kind"] == {"reshard": 1}
        assert report["unshard"]["bytes_by_kind"] == {"reshard": 16 * 4}
        np.testing.assert_array_equal(report["value"], np.arange(16, dtype=np.float32))


def test_sharded_catbuffer_keeps_overflow_flag(catbuffer):
    """The sticky overflow flag survives the placement, a captured step (the
    engines' flattener and statics) and the gather back."""
    for rank, report in enumerate(catbuffer):
        assert report["placed"] and report["captured"] and report["unsharded"]
        # rank 0 keeps the global buffer as its partial (every rank's 18 rows,
        # counted once each), the others an empty one with the global flag
        assert report["count"] == (WORLD * 18 if rank == 0 else 0)


# --------------------------------------------------------------------------- #
# fused collections with mixed members
# --------------------------------------------------------------------------- #
def _collection_data():
    rng = np.random.default_rng(0)
    return [(rng.random((64, 16), dtype=np.float32), rng.integers(0, 16, 64)) for _ in range(5)]


def _jax_collection_values(data):
    coll = mt_jax.MetricCollection({
        "acc": mt_jax.Accuracy(num_classes=16, average="micro"),
        "prec": mt_jax.Precision(num_classes=16, average="macro"),
        "confmat": mt_jax.ConfusionMatrix(num_classes=16),
    })
    for batch in data:
        coll.update(*map(jnp.asarray, batch))
    return {k: np.asarray(v) for k, v in coll.compute().items()}


def test_fused_collection_mixed_sharded_members(world):
    data = _collection_data()
    want = _jax_collection_values(data)
    for report in world.run(ts.collection_stream, [(b,) for b in _split(data)]):
        for key in ("acc", "confmat"):
            assert_bitwise(report["value"][key], want[key], msg=key)
        assert_close(report["value"]["prec"], want["prec"], rtol=1e-6, atol=1e-6)
        assert report["engine"]["compiled_calls"] > 0 and report["engine"]["donated_calls"] > 0
        assert report["confmat_block"] == (4, 16) and report["acc_active"] == {}


def test_collection_unshard_state(world):
    data = _collection_data()[:1]
    for report in world.run(ts.collection_stream, [(b, True, True) for b in _split(data)]):
        assert report["unsharded_active"] == {}
        for key, value in report["value"].items():
            assert_bitwise(report["after_unshard"][key], value, msg=key)


# --------------------------------------------------------------------------- #
# engine capture: collective bytes land in EngineStats
# --------------------------------------------------------------------------- #
def test_engine_stats_record_collective_bytes(world):
    rng = np.random.default_rng(0)
    data = [(rng.integers(0, 64, 64), rng.integers(0, 64, 64)) for _ in range(2)]
    reports = world.run(ts.compute_engine_stats, [(("ConfusionMatrix", {"num_classes": 64}), b) for b in _split(data)])
    for report in reports:
        assert report["cache_misses"] > 0 and not report["fallback_reasons"]
        # the captured protocol compute: one result gather of the 16-row block
        assert report["collective_counts"] == {"all_gather": 1}
        assert report["collective_bytes"] == {"all_gather": 16 * 64 * 4}

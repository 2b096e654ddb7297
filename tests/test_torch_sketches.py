"""The sketches and the sketch aggregators of the port (``metrics_tpu_torch/sketches``,
``Quantile``, ``Median``, ``DistinctCount``, ``HeavyHitters`` and
``AUROC(approx="sketch")``) against the JAX package on the CPU.

Integer components (registers, counters, totals) and the min/max trackers
compare bit for bit. A quantile-sketch bucket index is float32 ``log``
arithmetic, and XLA's ``log`` and torch's may differ by an ulp: where the
bucket counts differ, every value that lands in another bucket must lie
within ``BOUNDARY_RTOL`` (four float32 ulps of its position) of a bucket
boundary in float64, and the count differences must be exactly those
values'; the test reports how many there were. Float32 sums over registers
or buckets (``estimate``, the sketch AUROC) hold within 1e-6 relative.
Inputs come from seeded numpy generators.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt_jax
import metrics_tpu_torch as mt_torch
from metrics_tpu import sketches as jsk
from metrics_tpu_torch import sketches as tsk
from metrics_tpu_torch.sketches import hll as thll
from metrics_tpu.sketches import hll as jhll
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from tests.helpers import torch_dist as td
from tests.helpers.torch_port import assert_bitwise, use_card_replay_path

pytestmark = pytest.mark.filterwarnings("ignore")

RTOL = 1e-6
BOUNDARY_RTOL = 2.0 ** -21
WORLD = 4
CPU = "cpu"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = td.GlooWorld(WORLD, str(tmp_path_factory.mktemp("gloo")))
    yield w
    w.close()


N_KEYS = 2048  # one length for every key array: the JAX side compiles each op once per shape


def _keys(case, rng):
    """Key arrays of every kind canonical_u32 folds: signed, wide, float, bool."""
    if case == "int32":
        return rng.integers(-2 ** 31, 2 ** 31, N_KEYS, dtype=np.int64).astype(np.int32)
    if case == "int64_past_2_31":  # JAX with 64-bit types off truncates these to int32
        return rng.integers(2 ** 31, 2 ** 32, N_KEYS, dtype=np.int64)
    if case == "int64_past_2_32":
        return rng.integers(-2 ** 40, 2 ** 40, N_KEYS, dtype=np.int64)
    if case == "float32":
        x = rng.normal(size=N_KEYS).astype(np.float32)
        x[:5] = [0.0, -0.0, np.nan, np.inf, -np.inf]
        return x
    if case == "float64":
        return rng.normal(size=N_KEYS) * 1e3
    if case == "bool":
        return rng.integers(0, 2, N_KEYS).astype(bool)
    if case == "int8":
        return rng.integers(-128, 128, N_KEYS).astype(np.int8)
    return rng.integers(0, 256, N_KEYS).astype(np.uint8)


KEY_CASES = ["int32", "int64_past_2_31", "int64_past_2_32", "float32", "float64", "bool", "int8", "uint8"]


# the JAX references of the primitives, jitted (one compile per shape instead
# of one per operation; tests/sketches/test_sketch_primitives.py holds jitted
# inserts equal to eager ones)
_jax_hash = jax.jit(lambda k: jhll.fmix32(jhll.canonical_u32(k)))
_jax_insert = jax.jit(lambda sketch, x: sketch.insert(x))
_jax_insert_weighted = jax.jit(lambda sketch, x, w: sketch.insert(x, w))


def _jax_components(sketch):
    return {f: np.asarray(v) for f, v in sketch.components().items()}


def _assert_integer_components(got, want, msg, skip=()):
    for comp, value in _jax_components(want).items():
        if comp not in skip:
            assert_bitwise(getattr(got, comp), value, f"{msg}: {comp}")


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_bucket_index(x, min_magnitude, log_ratio):
    mag = jnp.abs(x)
    return jnp.floor(jnp.log(jnp.maximum(mag, min_magnitude) / min_magnitude) / log_ratio).astype(jnp.int32)


def _jax_bucket(x, sketch):
    """The JAX package's bucket index expression (QuantileSketch.insert),
    jitted as the JAX engine runs it."""
    idx = _jax_bucket_index(jnp.asarray(x, jnp.float32), sketch.min_magnitude, sketch._log_ratio)
    return np.clip(np.asarray(idx), 0, sketch.num_buckets - 1).astype(np.int64)


def assert_quantile_states(got, want, values):
    """``got`` (port) against ``want`` (JAX) after inserting ``values``: the
    scalars bitwise, the bucket counts bitwise but for values on a bucket
    boundary. Returns how many values landed in another bucket."""
    _assert_integer_components(got, want, "quantile", skip=("pos", "neg"))
    x = np.asarray(values, np.float32).reshape(-1)
    finite = np.isfinite(x) & (np.abs(x) >= np.float32(want.min_magnitude))
    idx_port = got.bucket_index(torch.from_numpy(x)).numpy()
    idx_jax = _jax_bucket(x, want)
    differ = finite & (idx_port != idx_jax)
    pos = np.log(np.abs(x[differ].astype(np.float64)) / want.min_magnitude) / want._log_ratio
    assert (np.abs(pos - np.round(pos)) <= BOUNDARY_RTOL * np.maximum(np.abs(pos), 1.0)).all(), pos
    b = want.num_buckets
    for comp, sign in (("pos", x > 0), ("neg", x < 0)):
        sel = differ & sign
        moved = np.bincount(idx_port[sel], minlength=b) - np.bincount(idx_jax[sel], minlength=b)
        np.testing.assert_array_equal(getattr(got, comp).numpy().astype(np.int64) - np.asarray(getattr(want, comp)),
                                      moved, err_msg=f"quantile {comp}: more than the boundary values differ")
    return int(differ.sum())


# --------------------------------------------------------------------------- #
# hashing and the primitives
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", KEY_CASES)
def test_fmix32_of_canonical_keys_is_bitwise_the_jax_hash(case):
    keys = _keys(case, np.random.default_rng(KEY_CASES.index(case)))
    want = np.asarray(_jax_hash(jnp.asarray(keys))).astype(np.int64)
    got = thll.fmix32(thll.canonical_u32(torch.from_numpy(keys)))
    assert got.dtype == torch.int64 and bool(((got >= 0) & (got < 2 ** 32)).all())
    np.testing.assert_array_equal(got.numpy(), want)


def test_clz32_is_the_jax_shift_chain():
    h = np.concatenate([[0, 1, 2, 3, 2 ** 31, 2 ** 32 - 1, 2 ** 16], np.random.default_rng(3).integers(0, 2 ** 32, 500)])
    want = np.asarray(jhll._clz32(jnp.asarray(h.astype(np.uint32))))
    assert_bitwise(thll._clz32(torch.from_numpy(h.astype(np.int64))), want, "clz32")


@pytest.mark.parametrize("precision,case", [(4, "int32"), (12, "int64_past_2_32"), (18, "float32"), (12, "bool")])
def test_hll_registers_bitwise_and_estimate(precision, case):
    keys = _keys(case, np.random.default_rng(precision))
    want = _jax_insert(jsk.HyperLogLogSketch(precision), jnp.asarray(keys))
    got = tsk.HyperLogLogSketch(precision, device=CPU).insert(torch.from_numpy(keys))
    _assert_integer_components(got, want, "hll")
    np.testing.assert_allclose(float(got.estimate()), float(want.estimate()), rtol=RTOL)


@pytest.mark.parametrize("weights", [False, True])
def test_countmin_counts_total_and_query_bitwise(weights):
    rng = np.random.default_rng(5)
    keys = rng.zipf(1.3, N_KEYS).astype(np.int64) % 4096
    w = rng.integers(1, 5, keys.shape) if weights else None
    sketch = jsk.CountMinSketch(256, 4)
    want = _jax_insert(sketch, jnp.asarray(keys)) if w is None else _jax_insert_weighted(sketch, jnp.asarray(keys), jnp.asarray(w))
    got = tsk.CountMinSketch(256, 4, device=CPU).insert(
        torch.from_numpy(keys), None if w is None else torch.from_numpy(w)
    )
    _assert_integer_components(got, want, "count-min")
    probe = np.arange(64)
    assert_bitwise(got.query(torch.from_numpy(probe)), np.asarray(want.query(jnp.asarray(probe))), "query")


def test_dyadic_countmin_and_heavy_hitters_match_jax():
    rng = np.random.default_rng(6)
    keys = rng.zipf(1.2, N_KEYS).astype(np.int64) % 1024
    want = _jax_insert(jsk.DyadicCountMinSketch(10, 128, 3), jnp.asarray(keys))
    got = tsk.DyadicCountMinSketch(10, 128, 3, device=CPU).insert(torch.from_numpy(keys))
    _assert_integer_components(got, want, "dyadic")
    for threshold, k in ((0.01, 8), (0.002, 32)):
        for a, b in zip(got.heavy_hitters(threshold, k), want.heavy_hitters(threshold, k)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(2))
def test_quantile_sketch_states_and_values(seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([
        rng.lognormal(size=N_KEYS * 3), -rng.lognormal(size=N_KEYS - 113), np.zeros(50), rng.uniform(0, 1e-9, 20),
        [np.nan, np.inf, -np.inf], rng.lognormal(mean=10, size=40),
    ]).astype(np.float32)
    want = _jax_insert(jsk.QuantileSketch(), jnp.asarray(x))
    got = tsk.QuantileSketch(device=CPU).insert(torch.from_numpy(x))
    moved = assert_quantile_states(got, want, x)
    print(f"quantile sketch, seed {seed}: {moved} of {x.size} values on a bucket boundary landed one bucket over")
    qs = [0.0, 0.01, 0.25, 0.5, 0.9, 0.999, 1.0]
    value = got.quantile(qs).numpy().astype(np.float64)
    finite = np.sort(x[np.isfinite(x)].astype(np.float64))
    exact = np.quantile(finite, qs, method="inverted_cdf")
    inside = np.abs(exact) >= got.min_magnitude
    assert (np.abs(value - exact)[inside] <= got.relative_accuracy * np.abs(exact)[inside]).all()
    if not moved:
        want_q = jax.jit(lambda sketch, q: sketch.quantile(q))(want, jnp.asarray(qs, jnp.float32))
        assert_bitwise(got.quantile(qs), np.asarray(want_q), "quantiles")


def test_quantile_sketch_empty_and_nonfinite():
    got = tsk.QuantileSketch(device=CPU).insert(torch.tensor([math.nan, math.inf, -math.inf]))
    assert int(got.count) == 0 and bool(torch.isnan(got.quantile(0.5)))
    empty = tsk.QuantileSketch(device=CPU)
    assert empty.insert(torch.zeros(0)).state_nbytes == empty.state_nbytes


# --------------------------------------------------------------------------- #
# the monoid, the base class, the registry
# --------------------------------------------------------------------------- #
def _shards(cls_kwargs, rng):
    cls, kw = cls_kwargs
    x = rng.lognormal(size=3000).astype(np.float32) if cls is tsk.QuantileSketch else rng.integers(0, 500, 3000)
    shards = [cls(**kw, device=CPU).insert(torch.from_numpy(part)) for part in np.array_split(x, 5)]
    return shards, cls(**kw, device=CPU).insert(torch.from_numpy(x))


SKETCHES = [
    (tsk.QuantileSketch, dict(num_buckets=1024, relative_accuracy=0.02)), (tsk.HyperLogLogSketch, dict(precision=6)),
    (tsk.CountMinSketch, dict(width=64, depth=3)), (tsk.DyadicCountMinSketch, dict(domain_bits=9, width=32, depth=2)),
]


@pytest.mark.parametrize("cls_kwargs", SKETCHES, ids=lambda ck: ck[0].__name__ if isinstance(ck, tuple) else None)
def test_merge_is_order_invariant_and_equals_the_whole_stream(cls_kwargs):
    shards, whole = _shards(cls_kwargs, np.random.default_rng(9))
    left = shards[0]
    for s in shards[1:]:
        left = left.merge(s)
    tree = shards[4].merge(shards[2]).merge(shards[0].merge(shards[3])).merge(shards[1])
    for comp, value in whole.components().items():
        assert_bitwise(getattr(left, comp), value.numpy(), comp)
        assert_bitwise(getattr(tree, comp), value.numpy(), comp)
    assert left.state_nbytes == whole.state_nbytes == cls_kwargs[0](**cls_kwargs[1], device=CPU).state_nbytes


@pytest.mark.parametrize("cls_kwargs", SKETCHES, ids=lambda ck: ck[0].__name__ if isinstance(ck, tuple) else None)
def test_registry_config_and_error_bound_match_jax(cls_kwargs):
    cls, kw = cls_kwargs
    jcls = jsk.SKETCH_CLASSES[cls.__name__]
    assert tsk.SKETCH_CLASSES[cls.__name__] is cls
    assert tsk.is_sketch(cls(**kw, device=CPU)) and not tsk.is_sketch(torch.zeros(1))
    assert cls.sketch_fields == jcls.sketch_fields and cls.config_attrs == jcls.config_attrs
    assert cls(**kw, device=CPU).config_dict() == jcls(**kw).config_dict()
    assert cls(**kw, device=CPU).error_bound() == jcls(**kw).error_bound()
    assert cls(**kw, device=CPU).state_nbytes == jcls(**kw).state_nbytes
    fresh = cls.from_config(cls(**kw, device=CPU).config_dict(), device=CPU)
    assert all(not v.any() or f == "vmin" or f == "vmax" for f, v in fresh.components().items())


@pytest.mark.parametrize("cls_kwargs", SKETCHES, ids=lambda ck: ck[0].__name__ if isinstance(ck, tuple) else None)
def test_sketch_state_defaults_to_cuda_and_refuses_input_elsewhere(cls_kwargs):
    cls, kw = cls_kwargs
    if torch.cuda.is_available():
        assert cls(**kw).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(**kw)
    with pytest.raises(ValueError, match="lies on meta"):
        cls(**kw, device=CPU).insert(torch.zeros(4, device="meta"))


def test_merge_refuses_other_types_and_configs():
    with pytest.raises(TypeError, match="cannot merge"):
        tsk.HyperLogLogSketch(6, device=CPU).merge(tsk.CountMinSketch(64, 2, device=CPU))
    with pytest.raises(ValueError, match="different configs"):
        tsk.HyperLogLogSketch(6, device=CPU).merge(tsk.HyperLogLogSketch(7, device=CPU))
    with pytest.raises(ValueError, match="unknown sketch components"):
        tsk.HyperLogLogSketch(6, device=CPU).replace(counts=torch.zeros(1))


# --------------------------------------------------------------------------- #
# the "sketch" reduction tag in Metric
# --------------------------------------------------------------------------- #
class _Bare(mt_torch.Metric):
    full_state_update = False

    def update(self, x):
        pass

    def compute(self):
        return None


def _tag_error(pkg, default, tag):
    """The error ``add_state`` raises in ``pkg`` for this default and tag."""
    cls = type("Bare", (pkg.Metric,), {"full_state_update": False, "update": lambda s, x: None, "compute": lambda s: None})
    metric = cls(device="cpu") if pkg is mt_torch else cls()
    with pytest.raises(ValueError) as err:
        metric.add_state("s", default=default, dist_reduce_fx=tag)
    return str(err.value)


@pytest.mark.parametrize("default,tag", [("sketch", "sum"), ("sketch", None), ("tensor", "sketch")])
def test_the_sketch_tag_errors_are_the_jax_packages(default, tag):
    make = {
        "sketch": lambda pkg: jsk.HyperLogLogSketch(5) if pkg is mt_jax else tsk.HyperLogLogSketch(5, device=CPU),
        "tensor": lambda pkg: jnp.zeros(3) if pkg is mt_jax else torch.zeros(3),
    }[default]
    assert _tag_error(mt_torch, make(mt_torch), tag) == _tag_error(mt_jax, make(mt_jax), tag)


def test_sync_tolerances_are_recorded_as_in_jax():
    for name, kwargs in (("Quantile", {}), ("DistinctCount", dict(precision=10)), ("HeavyHitters", {})):
        assert getattr(mt_torch, name)(device="cpu", **kwargs).sync_tolerances == getattr(mt_jax, name)(**kwargs).sync_tolerances
    assert mt_torch.AUROC(approx="sketch", device="cpu").sync_tolerances == mt_jax.AUROC(approx="sketch").sync_tolerances
    with pytest.raises(ValueError, match="sync_tolerance must be >= 0"):
        _Bare(device="cpu").add_state("s", torch.zeros(1), "sum", sync_tolerance=-1.0)


def test_state_dict_round_trip_reset_move_and_astype():
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.lognormal(size=500).astype(np.float32))
    metric = mt_torch.Quantile(q=[0.1, 0.9], device="cpu")
    metric.update(x)
    sd = metric.state_dict()
    assert set(sd["sketch"]) == {f for f, _ in tsk.QuantileSketch.sketch_fields}
    twin = mt_torch.Quantile(q=[0.1, 0.9], device="cpu")
    twin.load_state_dict(sd)
    assert torch.equal(twin.compute(), metric.compute())
    with pytest.raises(MetricsUserError, match="dict of components"):
        twin.load_state_dict({"sketch": torch.zeros(3)})
    metric.astype(torch.float64)
    assert metric.sketch.vmin.dtype == torch.float32  # sketches keep their dtypes, as in the JAX package
    metric.to("cpu")
    assert metric.sketch.device == torch.device("cpu")
    metric.reset()
    assert int(metric.sketch.count) == 0 and metric.sketch is not metric._defaults["sketch"]
    merged = metric.merge_states(twin.get_state(), twin.get_state())["sketch"]
    assert int(merged.count) == 2 * int(twin.sketch.count)


# --------------------------------------------------------------------------- #
# the aggregators and AUROC's sketch route against the JAX package
# --------------------------------------------------------------------------- #
def _aggregator_cases():
    rng = np.random.default_rng(21)
    values = [rng.lognormal(size=N_KEYS).astype(np.float32) for _ in range(3)]
    values[1][:5] = np.nan
    keys = [rng.integers(-5000, 5000, N_KEYS) for _ in range(3)]
    tokens = [(rng.zipf(1.3, N_KEYS) % 3000).astype(np.int32) for _ in range(3)]
    return {
        "Quantile": (dict(q=[0.05, 0.5, 0.95]), values),
        "Quantile_scalar": (dict(q=0.75), values),
        "Median": ({}, values),
        "DistinctCount": (dict(precision=10), keys),
        "HeavyHitters": (dict(threshold=0.02, max_hitters=6, domain_bits=12, width=256), tokens),
    }


AGGREGATORS = _aggregator_cases()


def _jax_run(ref, batches):
    """The JAX metric's pure ``update_state`` over ``batches``, jitted (one
    compile where eager JAX compiles each operation; the parity harness,
    tests/test_torch_parity.py, holds the JAX engines themselves), then its
    state set and its compute (jitted but for HeavyHitters' host descent)."""
    step = jax.jit(ref.update_state)
    state = ref.init_state()
    for args in batches:
        state = step(state, *map(jnp.asarray, args))
    ref.set_state(state)
    compute = ref.compute_state if isinstance(ref, mt_jax.HeavyHitters) else jax.jit(ref.compute_state)
    return ref, compute(state)


@functools.lru_cache(maxsize=None)
def _jax_aggregator(name):
    """The JAX package's metric fed the case's batches (once per worker)."""
    kwargs, batches = AGGREGATORS[name]
    return _jax_run(getattr(mt_jax, name.split("_")[0])(**kwargs), [(b,) for b in batches])


@pytest.mark.parametrize("compiled", [False, True])
@pytest.mark.parametrize("name", sorted(AGGREGATORS))
def test_aggregators_match_jax(name, compiled, monkeypatch):
    use_card_replay_path(monkeypatch)
    kwargs, batches = AGGREGATORS[name]
    cls = name.split("_")[0]
    flags = {} if compiled else dict(compiled_update=False, compiled_compute=False)
    ref, want = _jax_aggregator(name)
    port = getattr(mt_torch, cls)(device="cpu", **kwargs, **flags)
    for batch in batches:
        port.update(torch.from_numpy(batch))
    if cls in ("Quantile", "Median"):
        moved = assert_quantile_states(port.sketch, ref.sketch, np.concatenate(batches))
    else:
        moved = 0
        _assert_integer_components(port.sketch, ref.sketch, name)
    got = port.compute()
    if isinstance(want, dict):
        for key in want:
            assert_bitwise(got[key], np.asarray(want[key]), key)
    elif not moved:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    if compiled:
        stats = port.engine_stats()["update"]
        assert stats.cache_misses == 1 and stats.cache_hits == 1 and not stats.fallback_reasons
        assert port.engine_stats()["partition"]["update"] == {"path": "fused", "reason": "compilable"}


def _binary(rng, n=3000):
    target = (rng.uniform(size=n) < 0.4).astype(np.int32)
    preds = np.clip(rng.normal(0.35, 0.15, n) + 0.25 * target, 1e-4, 1.0).astype(np.float32)
    return preds, target


@functools.lru_cache(maxsize=None)
def _jax_auroc_sketch():
    preds, target = _binary(np.random.default_rng(31))
    ref, value = _jax_run(mt_jax.AUROC(pos_label=1, approx="sketch"),
                          [(preds[lo:lo + 500], target[lo:lo + 500]) for lo in range(0, len(preds), 500)])
    return preds, target, ref, value


@pytest.mark.parametrize("compiled", [False, True])
def test_auroc_sketch_matches_jax_and_the_exact_auroc(compiled, monkeypatch):
    use_card_replay_path(monkeypatch)
    preds, target, ref, want = _jax_auroc_sketch()
    flags = {} if compiled else dict(compiled_update=False, compiled_compute=False)
    port = mt_torch.AUROC(pos_label=1, approx="sketch", device="cpu", **flags)
    exact = mt_torch.AUROC(pos_label=1, device="cpu")
    for lo in range(0, len(preds), 500):
        p, t = preds[lo:lo + 500], target[lo:lo + 500]
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        exact.update(torch.from_numpy(p), torch.from_numpy(t))
    moved = assert_quantile_states(port.pos_scores, ref.pos_scores, np.where(target == 1, preds, np.nan))
    moved += assert_quantile_states(port.neg_scores, ref.neg_scores, np.where(target == 1, np.nan, preds))
    got = float(port.compute())
    if not moved:
        np.testing.assert_allclose(got, float(want), rtol=RTOL)
    assert abs(got - float(exact.compute())) <= 5e-3  # the JAX test's bound (tests/sketches/test_sketch_metrics.py)


def test_heavy_hitters_compute_stays_eager_and_forward_keeps_the_state():
    metric = mt_torch.HeavyHitters(threshold=0.3, max_hitters=2, device="cpu")
    assert metric.engine_stats()["partition"]["compute"] == {"path": "eager", "reason": "compiled_compute=False"}
    batch = metric(torch.tensor([7, 7, 7, 5, 5]))
    assert batch["keys"].tolist() == [7, 5]
    metric.update(torch.tensor([5, 5, 5, 5, 5]))
    assert metric.compute()["keys"].tolist() == [5, 7] and int(metric.sketch.total) == 10


# --------------------------------------------------------------------------- #
# sync in the gloo world of 4
# --------------------------------------------------------------------------- #
def test_sketch_sync_is_the_merge_and_adds_no_collective(world):
    rng = np.random.default_rng(41)
    parts = [(rng.lognormal(size=300 + 50 * r).astype(np.float32), rng.integers(0, 2000, 400)) for r in range(WORLD)]
    results = world.run(td.sketch_sync, parts)
    merged = None
    for values, keys in parts:
        state = td.sketch_state(values, keys)
        merged = state if merged is None else {
            k: (v.merge(merged[k]) if tsk.is_sketch(v) else v + merged[k]) for k, v in state.items()}
    # one all_reduce per (reduction, dtype) bucket: (sum, int32), (max, int32),
    # (min, float32), (max, float32), (sum, float32) shared with the dense leaf
    buckets = {(red, c.dtype) for v in merged.values() if tsk.is_sketch(v)
               for (f, red), c in zip(v.component_reductions(), v.components().values())} | {("sum", torch.float32)}
    per_leaf = sum(len(v.sketch_fields) if tsk.is_sketch(v) else 1 for v in merged.values())
    for rank, out in enumerate(results):
        assert out["counts_True"]["by_kind"] == {"all_reduce": len(buckets)}, rank
        assert out["counts_False"]["by_kind"] == {"all_reduce": per_leaf}, rank
        for bucketed in (True, False):
            for name, value in merged.items():
                if tsk.is_sketch(value):
                    for comp, c in value.components().items():
                        assert_bitwise(out[bucketed][name][comp], c.numpy(), f"rank {rank} {name}.{comp}")
                else:
                    np.testing.assert_array_equal(out[bucketed][name], value.numpy())


def test_auroc_sketch_synced_compute_matches_the_rank_major_oracle(world):
    preds, target = _binary(np.random.default_rng(43), 2000)
    per_rank = [[(preds[i::WORLD][lo:lo + 250], target[i::WORLD][lo:lo + 250]) for lo in range(0, 500, 250)]
                for i in range(WORLD)]
    results = world.run(td.auroc_sketch_synced, [(calls,) for calls in per_rank])
    oracle = mt_torch.AUROC(approx="sketch", device="cpu")
    for calls in per_rank:
        for p, t in calls:
            oracle.update(torch.from_numpy(p), torch.from_numpy(t))
    for rank, got in enumerate(results):
        assert_bitwise(got, oracle.compute().numpy(), f"rank {rank}")

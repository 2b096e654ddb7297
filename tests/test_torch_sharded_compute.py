"""The port's sharded-compute protocol against the JAX package's.

Mirrors ``tests/core/test_sharded_compute.py`` case for case. A placed
metric whose class ships ``compute_sharded_state`` computes on its blocks and
combines only its result (``psum_result`` / ``gather_result``): nothing
reshards. The port's side runs in one gloo world of 4 CPU ranks for the
module, rank ``r`` updating with the ``r``-th quarter of the data (made with
``np.random.default_rng``); the JAX side is computed once for the module
(``jax_refs``, one ``jax.jit`` call): every case's replicated value on the
whole data through the pure protocol, and for ``confmat`` (exact) and
``binned_ap`` (inexact) the JAX package's own ``sync_compute_state`` under
``shard_map`` on 4 of the 8 CPU devices.

Tolerances: bitwise where the JAX test marks a case exact (integer and
block-local finalizes); elsewhere rtol = atol = 1e-6, its ``_leaves_equal``
(a sum across the sharded class axis may round differently). Counts are the
port's own where they differ: its CatMetric protocol gathers the blocks in
one ``all_gather`` (the JAX package's ``CatBuffer.gather`` ticks three: the
counts and flags are global in the port already).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

import metrics_tpu as mt_jax
import metrics_tpu_torch as mt
from tests.helpers import torch_dist as td
from tests.helpers import torch_shard as ts
from tests.helpers.torch_port import assert_bitwise, assert_close, one_torch_thread  # noqa: F401  (the module fixture)

try:
    from jax import shard_map  # jax >= 0.8
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

pytestmark = [pytest.mark.usefixtures("one_torch_thread"), pytest.mark.filterwarnings("ignore")]

WORLD = 4
C = 64


def _cls_data(n=4096):
    rng = np.random.default_rng(0)
    return rng.integers(0, C, n), rng.integers(0, C, n)


def _prob_data(n=512):
    rng = np.random.default_rng(0)
    return rng.random((n, C), dtype=np.float32), rng.integers(0, C, n)


CASES = {
    "confmat": (("ConfusionMatrix", {"num_classes": C}), _cls_data, True),
    "confmat_norm_true": (("ConfusionMatrix", {"num_classes": C, "normalize": "true"}), _cls_data, True),
    "confmat_norm_pred": (("ConfusionMatrix", {"num_classes": C, "normalize": "pred"}), _cls_data, False),
    "confmat_norm_all": (("ConfusionMatrix", {"num_classes": C, "normalize": "all"}), _cls_data, False),
    "matthews": (("MatthewsCorrCoef", {"num_classes": C}), _cls_data, True),
    "stat_scores_macro": (("StatScores", {"reduce": "macro", "num_classes": C}), _cls_data, True),
    "precision_macro": (("Precision", {"average": "macro", "num_classes": C}), _cls_data, False),
    "precision_none": (("Precision", {"average": "none", "num_classes": C}), _cls_data, True),
    "recall_weighted": (("Recall", {"average": "weighted", "num_classes": C}), _cls_data, False),
    "binned_pr_curve": (("BinnedPrecisionRecallCurve", {"num_classes": C, "thresholds": 16}), _prob_data, True),
    "binned_ap": (("BinnedAveragePrecision", {"num_classes": C, "thresholds": 16}), _prob_data, False),
    "binned_recall_at_p": (("BinnedRecallAtFixedPrecision", {"num_classes": C, "thresholds": 16,
                                                              "min_precision": 0.5}), _prob_data, True),
}
SHARD_MAP_CASES = ("confmat", "binned_ap")
# MCC's value under jit is an ulp from the eager facade's (XLA fuses its float32
# products), and the exact case compares bits: its reference stays eager
EAGER_REFERENCES = ("matthews",)


def _split(data):
    return [tuple(np.array_split(x, WORLD)[r] for x in data) for r in range(WORLD)]


def _smap(fn, in_specs):
    mesh = JaxMesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    kwargs = dict(mesh=mesh, in_specs=in_specs, out_specs=P())
    try:
        return shard_map(fn, check_vma=False, **kwargs)
    except TypeError:  # pragma: no cover - pre-0.8 jax spells the flag check_rep
        return shard_map(fn, check_rep=False, **kwargs)


@pytest.fixture(scope="module")
def jax_refs():
    """Every case's replicated value (the pure protocol on the whole data)
    and, for ``SHARD_MAP_CASES``, the JAX package's protocol under
    ``shard_map``: one ``jax.jit`` call for the module."""
    mesh = JaxMesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    metrics = {key: getattr(mt_jax, cls)(**kwargs) for key, ((cls, kwargs), _, _) in CASES.items()}
    for key in SHARD_MAP_CASES:
        metrics[key]._state_sharding = (mesh, "data")  # the pure protocol reads the placement only

    def run(data):
        out = {}
        for key, m in metrics.items():
            if key in EAGER_REFERENCES:
                continue
            state = m.update_state(m.init_state(), *data[key])
            out[key] = {"value": m.compute_state(state)}
            if key in SHARD_MAP_CASES:
                active = m.active_shard_axes
                in_specs = ({k: P("data") if active.get(k) is not None else P() for k in state},)
                out[key]["shard_map"] = _smap(lambda st, m=m: m.sync_compute_state(st, axis_name="data"), in_specs)(state)
        return out

    data = {key: [jnp.asarray(x) for x in data_fn()] for key, (_, data_fn, _) in CASES.items()}
    out = jax.device_get(jax.jit(run)(data))
    for key in EAGER_REFERENCES:
        metrics[key].update(*data[key])
        out[key] = {"value": np.asarray(metrics[key].compute())}
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = td.GlooWorld(WORLD, str(tmp_path_factory.mktemp("gloo")))
    yield w
    w.close()


def _assert_tree(got, want, exact, msg):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), msg
        for g, w in zip(got, want):
            _assert_tree(g, w, exact, msg)
    elif exact:
        assert_bitwise(got, want, msg=msg)
    else:
        assert_close(got, want, rtol=1e-6, atol=1e-6, msg=msg)


# --------------------------------------------------------------------------- #
# eligibility: the MRO guard
# --------------------------------------------------------------------------- #
DECLARING = [
    ("ConfusionMatrix", {"num_classes": 8}),
    ("MatthewsCorrCoef", {"num_classes": 8}),
    ("StatScores", {"reduce": "macro", "num_classes": 8}),
    ("Precision", {"average": "macro", "num_classes": 8}),
    ("Recall", {"average": "none", "num_classes": 8}),
    ("BinnedPrecisionRecallCurve", {"num_classes": 8, "thresholds": 5}),
    ("BinnedAveragePrecision", {"num_classes": 8, "thresholds": 5}),
    ("BinnedRecallAtFixedPrecision", {"num_classes": 8, "thresholds": 5, "min_precision": 0.5}),
    ("CatMetric", {"buffer_capacity": 16}),
]


def test_declaring_metrics_support_sharded_compute():
    for cls, kwargs in DECLARING:
        port, jax_twin = getattr(mt, cls)(device="cpu", **kwargs), getattr(mt_jax, cls)(**kwargs)
        assert port.supports_sharded_compute and jax_twin.supports_sharded_compute, cls
        assert port.shard_axes == jax_twin.shard_axes, cls
    # the layouts that stay replicated, and the retrieval buffers (which reshard)
    for cls, kwargs in [("StatScores", {"reduce": "micro"}), ("RetrievalMAP", {"buffer_capacity": 8}),
                        ("RetrievalMAP", {}), ("CatMetric", {})]:
        port, jax_twin = getattr(mt, cls)(device="cpu", **kwargs), getattr(mt_jax, cls)(**kwargs)
        assert port.shard_axes == jax_twin.shard_axes, (cls, kwargs)
        assert port.supports_sharded_compute == jax_twin.supports_sharded_compute, (cls, kwargs)


def test_compute_override_disables_inherited_sharded_compute():
    """A subclass that redefines ``compute`` alone must reshard, not finalize
    its parent's metric."""
    assert not mt.F1Score(num_classes=8, average="macro", device="cpu").supports_sharded_compute

    class _Doubled(mt.ConfusionMatrix):
        def compute(self):
            return super().compute() * 2

    assert not _Doubled(num_classes=8, device="cpu").supports_sharded_compute

    class _Redeclared(_Doubled):
        def compute_sharded_state(self, state, group):
            return super().compute_sharded_state(state, group) * 2

    assert _Redeclared(num_classes=8, device="cpu").supports_sharded_compute


def test_base_stub_raises():
    with pytest.raises(NotImplementedError):
        mt.Metric.compute_sharded_state(mt.ConfusionMatrix(num_classes=4, device="cpu"), {}, None)


# --------------------------------------------------------------------------- #
# parity sweep: the protocol against the JAX package's replicated compute
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def protocol_reports(world):
    out = {}
    for key, (spec, data_fn, _) in CASES.items():
        out[key] = world.run(ts.protocol, [(spec, [batch], key == "confmat") for batch in _split(data_fn())])
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_protocol_parity_zero_reshard(protocol_reports, jax_refs, case):
    exact = CASES[case][2]
    for rank, report in enumerate(protocol_reports[case]):
        assert report["supports"]
        _assert_tree(report["value"], jax_refs[case]["value"], exact, f"{case} rank {rank}")
        # the protocol's point: no state re-materialization...
        assert report["protocol"]["by_kind"].get("reshard", 0) == 0
        assert report["protocol"]["bytes_by_kind"].get("reshard", 0) == 0
        # ...while the combine really did cross ranks with result-sized traffic
        assert report["protocol"]["count"] >= 1
        # and the same blocks, synced without the protocol, reshard
        assert report["reshard"]["by_kind"].get("reshard", 0) >= 1


@pytest.mark.parametrize("case", SHARD_MAP_CASES)
def test_protocol_matches_the_jax_shard_map(protocol_reports, jax_refs, case):
    """The port's protocol against the JAX package's own protocol under
    ``shard_map`` (``confmat`` bitwise, ``binned_ap`` within 1e-6)."""
    for report in protocol_reports[case]:
        _assert_tree(report["value"], jax_refs[case]["shard_map"], CASES[case][2], case)


def test_catmetric_protocol_gathers_without_reshard(world):
    """CatMetric's protocol gathers its blocks as the result: one
    "all_gather" (the JAX package ticks three), no "reshard"; a plain sync of
    the same blocks reshards."""
    per_rank = _split((np.arange(WORLD * 2, dtype=np.float32),))
    reports = world.run(ts.protocol, [(("CatMetric", {"buffer_capacity": WORLD * 2}), [b]) for b in per_rank])
    for report in reports:
        assert report["protocol"]["by_kind"] == {"all_gather": 1}
        assert report["reshard"]["by_kind"].get("reshard", 0) >= 1
        np.testing.assert_array_equal(report["value"], np.arange(WORLD * 2, dtype=np.float32))


# --------------------------------------------------------------------------- #
# routing: who takes the protocol, who reshards
# --------------------------------------------------------------------------- #
def test_protocol_traffic_is_result_sized(world):
    reports = world.run_all(ts.sync_counts, ("ConfusionMatrix", {"num_classes": C}), True, None, "data", True, True)
    for report in reports:
        # one result gather of the local block, nothing tagged as reshard
        assert report["box"]["by_kind"] == {"all_gather": 1}
        assert report["box"]["bytes_by_kind"] == {"all_gather": (C // WORLD) * C * 4}


def test_non_declaring_metric_still_reshards(world):
    spec = ("F1Score", {"num_classes": C, "average": "macro"})
    for report in world.run_all(ts.sync_counts, spec, True, None, "data", True, True):
        assert not report["supports"]
        assert report["box"]["by_kind"].get("reshard", 0) >= 1


def test_inactive_sharding_skips_protocol(world):
    """A declaration alone does not route: an unplaced leaf is the rank's
    partial value, which the protocol would gather as duplicates."""
    spec = ("ConfusionMatrix", {"num_classes": C})
    for report in world.run_all(ts.sync_counts, spec, False, None, "data", True, True):
        assert report["supports"] and report["active"] == {}
        assert report["box"]["by_kind"].get("all_gather", 0) == 0
        assert report["box"]["by_kind"].get("all_reduce", 0) >= 1


def test_group_none_skips_protocol(protocol_reports):
    """``sync_compute_state(state, None)`` syncs nothing. The port's state is
    this rank's block, so the value is the block's (the JAX package's global
    array computes to the whole (C, C) matrix there)."""
    for report in protocol_reports["confmat"]:
        assert report["local"]["box"]["count"] == 0
        assert report["local"]["shape"] == (C // WORLD, C)


# --------------------------------------------------------------------------- #
# forward and sync_on_compute=False: a placed metric's blocks are never its value
# --------------------------------------------------------------------------- #
FORWARD_CASES = {"confmat": ("ConfusionMatrix", {"num_classes": C}),
                 "matthews": ("MatthewsCorrCoef", {"num_classes": C})}
FORWARD_BATCHES = 2


def _forward_batches():
    """``FORWARD_BATCHES`` global batches of ``_cls_data``; rank r's share of
    each is its r-th quarter."""
    return [tuple(np.array_split(x, FORWARD_BATCHES)[b] for x in _cls_data()) for b in range(FORWARD_BATCHES)]


@pytest.fixture(scope="module")
def jax_forward_refs():
    """The JAX package's ``metric(*batch)`` per whole global batch, then
    ``compute()`` (eager, as the exact ``matthews`` reference is)."""
    out = {}
    for key, (cls, kwargs) in FORWARD_CASES.items():
        m = getattr(mt_jax, cls)(compiled_update=False, compiled_compute=False, **kwargs)
        batch_values = [np.asarray(m(*[jnp.asarray(x) for x in batch])) for batch in _forward_batches()]
        out[key] = {"batch_values": batch_values, "value": np.asarray(m.compute())}
    return out


def _forward_args(spec, collection=False):
    per_batch = [_split(batch) for batch in _forward_batches()]
    return [(spec, [per_batch[b][r] for b in range(FORWARD_BATCHES)], collection) for r in range(WORLD)]


@pytest.mark.parametrize("sync_on_compute", [True, False], ids=["sync_on_compute", "no_sync_on_compute"])
@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_forward_of_a_placed_metric_is_global(world, jax_forward_refs, case, sync_on_compute):
    """``forward`` computes its batch value with ``dist_sync_on_step=False``
    and ``sync_on_compute=False`` turns the compute-time sync off, yet a
    placed metric syncs over its placement in both: every rank returns the
    global batch's value and the global value (bitwise, as JAX), never its
    block's, and keeps its block."""
    cls, kwargs = FORWARD_CASES[case]
    reports = world.run(ts.forward_stream, _forward_args((cls, {**kwargs, "sync_on_compute": sync_on_compute})))
    want = jax_forward_refs[case]
    for rank, report in enumerate(reports):
        for b, (got, ref) in enumerate(zip(report["batch_values"], want["batch_values"])):
            assert_bitwise(got, ref, msg=f"{case} rank {rank} batch {b}")
        assert_bitwise(report["value"], want["value"], msg=f"{case} rank {rank} compute")
        assert report["shapes"] == [{"confmat": (C // WORLD, C)}]


@pytest.mark.parametrize("sync_on_compute", [True, False], ids=["sync_on_compute", "no_sync_on_compute"])
def test_collection_of_placed_members(world, jax_forward_refs, sync_on_compute):
    """A collection whose placed members share one compute group: with
    ``sync_on_compute`` the leader reshards once and the members compute on
    the whole state it shares; without it each member syncs its own blocks.
    Both in ``forward`` and in ``compute()``."""
    spec = ("ConfusionMatrix", {"num_classes": C, "sync_on_compute": sync_on_compute})
    want = jax_forward_refs["confmat"]
    for rank, report in enumerate(world.run(ts.forward_stream, _forward_args(spec, collection=True))):
        assert report["compute_groups"] == [["a", "b"]]
        for b, (got, ref) in enumerate(zip(report["batch_values"], want["batch_values"])):
            for name in ("a", "b"):
                assert_bitwise(got[name], ref, msg=f"rank {rank} batch {b} {name}")
        for name in ("a", "b"):
            assert_bitwise(report["value"][name], want["value"], msg=f"rank {rank} compute {name}")
        assert report["shapes"] == [{"confmat": (C // WORLD, C)}] * 2

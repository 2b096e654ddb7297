"""The port's multi-process sync in a gloo world of 4 CPU ranks.

One world is spawned for the module (``tests/helpers/torch_dist.py``, file
store under ``tmp_path``, a 120 s watchdog on every call). Each rank updates
its own seeded batches; the synced ``compute()`` must equal a single-process
oracle, the same port metric fed every rank's batches in rank-major order
(the order the gathers produce, on which mAP's tie order and BERTScore's
per-pair lists depend). States, counts, IoU/match-based and binned results
are bitwise; so are the float results here, which are computed from equal
states by the same code.

The collective counts are held against the JAX package's
``count_collectives`` over a traced ``shard_map`` of the same
``sync_states`` on 4 devices of the 8-device CPU mesh: ``psum`` and its kin
are an ``all_reduce`` in the port; the port's shape exchanges of ragged
``cat`` gathers count apart, as ``size_exchange``.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import metrics_tpu as mt_jax
from __graft_entry__ import _make_collection as jax_collection
from metrics_tpu.parallel import sync as jax_sync
from metrics_tpu_torch.parallel import gather_all_arrays, sync_state
from tests.helpers import torch_dist as td
from tests.helpers.torch_port import assert_bitwise, coco_dataset

try:
    from jax import shard_map  # jax >= 0.8
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

WORLD = 4
C = td.C
TWINS = [
    "StatScores", "Accuracy", "Precision", "Recall", "F1Score", "FBetaScore",
    "BinnedPrecisionRecallCurve", "BinnedAveragePrecision", "BinnedRecallAtFixedPrecision",
    "MeanAveragePrecision", "BERTScore", "CompositionalMetric",
]
WORDS = [w for w in td.VOCAB if not w.startswith("[")]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = td.GlooWorld(WORLD, str(tmp_path_factory.mktemp("gloo")))
    yield w
    w.close()


# --------------------------------------------------------------------------- #
# seeded inputs, per rank
# --------------------------------------------------------------------------- #
def _sentences(rng, n, longest=5):
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(1, longest + 1)))) for _ in range(n)]


def _batch(name, rng, rows=16):
    if name == "MeanAveragePrecision":
        return coco_dataset(rng, 3, n_classes=3)
    if name == "BERTScore":
        return _sentences(rng, 3), _sentences(rng, 3)
    if name == "ImageNetWidth":
        logits = rng.normal(size=(64, 1000)).astype(np.float32)
        probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
        return probs, rng.integers(0, 1000, size=64).astype(np.int64)
    logits = rng.normal(size=(rows, C)).astype(np.float32)
    if name.startswith("Binned"):
        logits = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
    return logits, rng.integers(0, C, size=rows).astype(np.int64)


def _rank_batches(name, seed, per_rank=2):
    rng = np.random.default_rng(seed)
    return [[_batch(name, rng) for _ in range(per_rank)] for _ in range(WORLD)]


def _oracle(name, rank_batches, **kwargs):
    return td.feed(td.make_metric(name, **kwargs), [b for batches in rank_batches for b in batches])


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _assert_tree_bitwise(got, want, msg=""):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want), msg
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, str):
            assert g == w, msg
        else:
            assert_bitwise(np.asarray(g), np.asarray(w), msg=f"{msg}[{i}]")


def _state_of(metric):
    """Oracle state as numpy, with cat lists concatenated as the sync returns them."""
    out = {}
    for k, v in metric.get_state().items():
        if isinstance(v, list):
            out[k] = [np.concatenate([x.numpy() for x in v])] if v else []
        else:
            out[k] = td.to_numpy(v)
    return out


# --------------------------------------------------------------------------- #
# the 12 twins, and one case at ImageNet state width
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", TWINS + ["ImageNetWidth"])
def test_synced_compute_equals_the_rank_major_oracle(world, name):
    rank_batches = _rank_batches(name, seed=TWINS.index(name) if name in TWINS else 99)
    reports = world.run(td.synced_compute, [(name, b) for b in rank_batches])
    oracle = _oracle(name, rank_batches)
    want = td.to_numpy(oracle.compute())
    oracle_states = [_state_of(m) for m in td._leaf_metrics(oracle)]
    for rank, report in enumerate(reports):
        _assert_tree_bitwise(report["result"], want, msg=f"{name} rank {rank} result")
        _assert_tree_bitwise(report["synced"], oracle_states, msg=f"{name} rank {rank} synced state")
        _assert_tree_bitwise(report["restored"], report["local"], msg=f"{name} rank {rank} state after unsync")
        assert report["counts"] == reports[0]["counts"]
    kinds = reports[0]["counts"]["by_kind"]
    n_leaf_metrics = len(oracle_states)
    if name == "MeanAveragePrecision":
        assert kinds == {"all_gather": 3}  # counts and flags, then float32 and int32 payloads
    elif name == "BERTScore":
        assert kinds == {"size_exchange": 1, "all_gather": 1}  # four int32 cat lists, one bucket
    else:
        assert kinds == {"all_reduce": n_leaf_metrics}


def test_collection_syncs_once_per_compute_group(world):
    rank_batches = _rank_batches("Accuracy", seed=21)
    reports = world.run(td.collection_compute, [(C, b) for b in rank_batches])
    oracle = td.make_collection(C)
    for batch in (b for batches in rank_batches for b in batches):
        oracle.update(*td.to_torch(batch))
    want = td.to_numpy(oracle.compute())
    assert len(oracle.compute_groups) == 2
    for report in reports:
        assert report["counts"]["by_kind"] == {"all_reduce": 2}
        _assert_tree_bitwise(report["result"], want)
        # compute leaves every member's local state in place
        assert report["states"]["acc"]["tp"].sum() < oracle["acc"].tp.sum()


def test_collection_at_imagenet_width(world):
    rng = np.random.default_rng(5)
    rank_batches = [[(rng.normal(size=(64, 1000)).astype(np.float32), rng.integers(0, 1000, 64)) for _ in range(2)]
                    for _ in range(WORLD)]
    reports = world.run(td.collection_compute, [(1000, b) for b in rank_batches])
    oracle = td.make_collection(1000)
    for batch in (b for batches in rank_batches for b in batches):
        oracle.update(*td.to_torch(batch))
    want = td.to_numpy(oracle.compute())
    for report in reports:
        _assert_tree_bitwise(report["result"], want)


# --------------------------------------------------------------------------- #
# collective counts against the JAX package
# --------------------------------------------------------------------------- #
_TABLE = td.TABLE.numpy()


def _jax_target(kind):
    if kind == "collection":
        return jax_collection(C)
    if kind == "BinnedAveragePrecision":
        return mt_jax.BinnedAveragePrecision(num_classes=C, thresholds=21)
    if kind == "StatScores":
        return mt_jax.StatScores(num_classes=C, reduce="macro")
    if kind == "MeanAveragePrecision":
        return mt_jax.MeanAveragePrecision(class_metrics=True)
    if kind == "BERTScore":
        return mt_jax.BERTScore(model=object(), user_tokenizer=td.ToyTokenizer(8),
                                user_forward_fn=lambda model, batch: _TABLE[np.asarray(batch["input_ids"])], max_length=8)
    raise KeyError(kind)


def _jax_batch(batch):
    if isinstance(batch[0], list) and batch[0] and isinstance(batch[0][0], dict):
        return tuple([{k: jnp.asarray(v) for k, v in item.items()} for item in part] for part in batch)
    return tuple(jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in batch)


def _jax_sync_kinds(target, state):
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    specs = jax.tree_util.tree_map(lambda _: P(), state)
    kwargs = dict(mesh=mesh, in_specs=(specs,), out_specs=specs)
    try:
        smapped = shard_map(lambda st: target.sync_states(st, "data"), check_vma=False, **kwargs)
    except TypeError:  # pragma: no cover - pre-0.8 jax spells the flag check_rep
        smapped = shard_map(lambda st: target.sync_states(st, "data"), check_rep=False, **kwargs)
    with jax_sync.count_collectives() as box:
        jax.make_jaxpr(smapped)(state)
    kinds = {}
    for kind, n in box["by_kind"].items():
        port_kind = "all_reduce" if kind in ("psum", "pmean", "pmax", "pmin") else kind
        kinds[port_kind] = kinds.get(port_kind, 0) + n
    return kinds


@pytest.mark.parametrize("kind", ["collection", "StatScores", "BinnedAveragePrecision", "MeanAveragePrecision", "BERTScore"])
def test_payload_collectives_equal_the_jax_packages(world, kind):
    batch = _batch("Accuracy" if kind in ("collection", "StatScores") else kind, np.random.default_rng(3))
    reports = world.run_all(td.pure_sync_counts, kind, batch)
    target = _jax_target(kind)
    state = target.update_state(target.init_state(), *_jax_batch(batch))
    want = _jax_sync_kinds(target, state)
    for box in reports:
        got = dict(box["by_kind"])
        ragged = got.pop("size_exchange", 0)
        assert got == want, (kind, box["by_kind"], want)
        assert ragged <= (1 if kind == "BERTScore" else 0)


# --------------------------------------------------------------------------- #
# buckets against per-leaf sync, ragged gathers, empty ranks
# --------------------------------------------------------------------------- #
# The float ``sum`` leaves hold dyadic values, whose sums are exact in any
# order: gloo's ring reduction adds one element's values in an order set by
# its position in the buffer, so a bucket and a lone leaf may round
# arbitrary floats differently. The metrics' float sums hold integer counts.
_REDUCTIONS = {
    "hits": "sum", "misses": "sum", "grid": "sum", "mass": "sum", "avg": "mean", "hi": "max", "lo": "min",
    "flag": "max", "chunks": "cat", "ids": "cat", "mask": "cat", "per": None, "per2": None, "best": "callable",
}


def _synthetic_state(rank):
    rng = np.random.default_rng(100 + rank)
    rows = [0, 3, 1, 5][rank]  # rank 0 appended an empty batch
    return {
        "hits": rng.integers(0, 9, size=3).astype(np.int32),
        "misses": rng.integers(0, 9, size=(2, 2)).astype(np.int32),
        "grid": np.float32(rank + 0.5) * np.ones((2, 3), np.float32),
        "mass": np.asarray(rng.integers(-8, 8) / 4, np.float32),
        "avg": rng.normal(size=4).astype(np.float32),
        "hi": rng.normal(size=2).astype(np.float32),
        "lo": rng.integers(-9, 9, size=2).astype(np.int32),
        "flag": np.asarray([rank == 2, False]),
        "chunks": [rng.normal(size=(rows, 3)).astype(np.float32), rng.normal(size=(1, 3)).astype(np.float32)],
        "ids": [rng.integers(0, 9, size=(rows, 4)).astype(np.int32)],
        "mask": [np.ones((rank + 1, 4), np.int32)],
        "per": rng.normal(size=2).astype(np.float32),
        "per2": rng.normal(size=(1, 2)).astype(np.float32),
        "best": rng.normal(size=3).astype(np.float32),
    }


def test_bucketed_equals_per_leaf_and_numpy(world):
    states = [_synthetic_state(r) for r in range(WORLD)]
    reports = world.run(td.bucketed_against_per_leaf, [(s, _REDUCTIONS) for s in states])
    want = {
        "hits": sum(s["hits"] for s in states), "misses": sum(s["misses"] for s in states),
        "grid": sum(s["grid"] for s in states), "mass": sum(s["mass"] for s in states),
        "hi": np.max([s["hi"] for s in states], 0), "lo": np.min([s["lo"] for s in states], 0),
        "flag": np.any([s["flag"] for s in states], 0),
        "chunks": [np.concatenate([c for s in states for c in s["chunks"]])],
        "ids": [np.concatenate([s["ids"][0] for s in states])],
        "mask": [np.concatenate([s["mask"][0] for s in states])],
        "per": np.stack([s["per"] for s in states]), "per2": np.stack([s["per2"] for s in states]),
        "best": np.max([s["best"] for s in states], 0),
    }
    for report in reports:
        _assert_tree_bitwise(report[True], report[False], msg="bucketed vs per-leaf")
        for key, value in want.items():
            _assert_tree_bitwise(report[True][key], value, msg=key)
        np.testing.assert_allclose(report[True]["avg"], np.mean([s["avg"] for s in states], 0), rtol=1e-6)
        assert report[True]["mass"].dtype == np.float32 and report[True]["flag"].dtype == bool
        # one collective per (reduction, dtype) bucket, one shape exchange per cat bucket
        assert report["counts_True"]["by_kind"] == {"all_reduce": 6, "size_exchange": 2, "all_gather": 4}
        assert report["counts_False"]["count"] > report["counts_True"]["count"]


def test_gather_all_arrays_trims_ragged_rows(world):
    reports = world.run(_gather_rows, [(r,) for r in range(WORLD)])
    for report in reports:
        assert [len(x) for x in report] == [0, 1, 2, 3]
        assert_bitwise(np.concatenate(report), np.repeat(np.arange(WORLD), np.arange(WORLD)).astype(np.float32))


def _gather_rows(rank):
    return [x.numpy() for x in gather_all_arrays(torch.full((rank,), float(rank)))]


def test_a_clone_shares_the_process_group(world):
    assert world.run_all(td.clone_shares_the_group) == [True] * WORLD


def test_mesh_groups_along_each_axis(world):
    for rank, layout in enumerate(world.run_all(td.mesh_layout, [2, 2])):
        d, m = divmod(rank, 2)
        assert layout["coords"] == (d, m) and layout["sizes"] == (2, 2)
        assert layout["data"] == [m, 2 + m]
        assert layout["model"] == [2 * d, 2 * d + 1]
        assert layout["('data', 'model')"] == [0, 1, 2, 3]


def test_the_rank_helper_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import tests.helpers.torch_dist\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'metrics_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    repo = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sync_state_without_a_group_is_the_identity():
    state = {"a": torch.ones(2), "b": [torch.ones(1)]}
    out = sync_state(state, {"a": "sum", "b": "cat"}, None)
    assert out["a"] is state["a"] and out["b"] is state["b"]


# --------------------------------------------------------------------------- #
# the facade
# --------------------------------------------------------------------------- #
def test_state_machine_errors(world):
    for errors in world.run_all(td.state_machine):
        assert errors == [
            "The Metric has already been synced.",
            "The Metric shouldn't be synced when performing ``forward``. HINT: Did you forget to call ``unsync`` ?.",
            "The Metric has already been un-synced.",
            "The internal cache should exist to unsync the Metric.",
        ]


def test_dist_sync_on_step_sync_on_compute_and_compute_on_cpu(world):
    rank_batches = _rank_batches("Accuracy", seed=31, per_rank=3)
    reports = world.run(td.forward_and_flags, [(b,) for b in rank_batches])
    for step in range(3):
        step_oracle = td.mt.Accuracy(num_classes=C, average="micro", device="cpu")
        td.feed(step_oracle, [batches[step] for batches in rank_batches])
        for rank, report in enumerate(reports):
            assert_bitwise(report["step_values"][step], step_oracle.compute().numpy())  # synced batch value
            local = td.feed(td.mt.Accuracy(num_classes=C, average="micro", device="cpu"), [rank_batches[rank][step]])
            assert_bitwise(report["plain_values"][step], local.compute().numpy())  # local batch value
    everything = td.feed(td.mt.Accuracy(num_classes=C, average="micro", device="cpu"),
                         [b for batches in rank_batches for b in batches])
    for rank, report in enumerate(reports):
        assert_bitwise(report["on_step_compute"], everything.compute().numpy())
        own = td.feed(td.mt.Accuracy(num_classes=C, average="micro", device="cpu"), rank_batches[rank])
        assert_bitwise(report["unsynced_compute"], own.compute().numpy())  # sync_on_compute=False
        assert report["on_cpu_devices"] == ["cpu"]
        assert report["on_cpu_result"]["f1"][0] == pytest.approx(1.0)
        assert len(report["on_cpu_result"]["f1"]) == 2 * WORLD


def test_catbuffer_ranks_of_different_capacities_and_an_empty_rank(world):
    rng = np.random.default_rng(41)
    images = [0, 1, 3, 6]  # rank 0 has no rows; with capacity 2 the others grow to 2, 4 and 8 images
    rank_batches = [[coco_dataset(rng, n, n_classes=3)] if n else [] for n in images]
    reports = world.run(td.synced_compute, [("MeanAveragePrecision", b, {"buffer_capacity": 2}) for b in rank_batches])
    oracle = _oracle("MeanAveragePrecision", rank_batches, buffer_capacity=2)
    want = td.to_numpy(oracle.compute())
    for rank, report in enumerate(reports):
        _assert_tree_bitwise(report["result"], want, msg=f"rank {rank}")
        assert len(report["synced"][0]["det_counts"]) == sum(images)
        assert len(report["local"][0]["det_counts"]) == images[rank]


def test_bertscore_widths_that_differ_across_ranks_raise(world):
    sentences = [["hello"], ["hello there"], ["hello there master"], ["hi"]]
    for message in world.run(td.bert_width_error, [(s,) for s in sentences]):
        assert "different trailing shapes" in message and "(3,)" in message and "(5,)" in message


def test_bertscore_widths_that_differ_within_a_rank_raise():
    metric = td.make_metric("BERTScore", width=None)
    metric.update(["hello"], ["hello"])
    metric.update(["hello there"], ["hello there"])
    with pytest.raises(ValueError, match=r"different trailing shapes \[\(3,\), \(4,\)\]"):
        metric.sync_states(metric.get_state(), group=object())  # raised before any collective

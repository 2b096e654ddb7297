"""The factory parity harness over every ``INVENTORY`` entry with a port twin.

``tests/helpers/torch_parity.py`` builds both twins from one entry (the
twin table is ``tests/helpers/torch_twins.py``) and runs the checks this
module parametrizes: hyperparameters, (a) eager parity, (b) the engine
partition at the defaults, (c) the buffered factory, and (d) the synced
compute in one gloo world of 4 ranks for the module, against the rank-major
oracle (the same twin fed every rank's rows in rank order), bit for bit.

The bound for results that are float sums is ``RTOL``/``ATOL`` = 1e-6 there;
states are compared bit for bit, except the float32 sums of the entries in
``FLOAT_SUM_STATES``, which are held to that bound; results are bit for bit
where ``BITWISE_RESULTS`` names the entry, and synced results bit for bit
against the oracle unless the entry sums float32 states. The pinned list of untwinned entries
shrinks by hand with each slice.
"""
import numpy as np
import pytest

import metrics_tpu as mt_jax
import metrics_tpu_torch as mt_torch
from tests.helpers import torch_dist as td
from tests.helpers import torch_parity as hp
from tests.helpers.inventory import INVENTORY
from tests.helpers.torch_port import coco_dataset, local_punkt_only, one_torch_thread  # noqa: F401
from tests.helpers.torch_twins import TWINS, make_twin

NAMES = sorted(TWINS)
BUFFERED = [n for n in NAMES if hp.has_buffered(n)]
WORLD = 4

# every INVENTORY entry has its twin since the audio slice (A15)
UNTWINNED_AFTER_SLICE_14 = set()

# one torch thread: after any explicit ``torch.set_num_threads(n > 1)`` (which
# ``one_torch_thread`` calls when it restores the count after an image or
# audio module in the same worker), torch 2.13.0+cpu's MKL corrupts its
# pivots in a batched LU and hangs (SDR's ``solve_ex``); with one thread it
# does not
pytestmark = [pytest.mark.filterwarnings("ignore"), pytest.mark.usefixtures("one_torch_thread")]


@pytest.fixture(autouse=True)
def _no_punkt_download(monkeypatch):
    local_punkt_only(monkeypatch)


@pytest.fixture(autouse=True)
def _engines_at_defaults():
    for pkg in (mt_jax, mt_torch):
        pkg.set_compiled_update(None)
        pkg.set_compiled_compute(None)
        pkg.set_fused_update(None)
    yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = td.GlooWorld(WORLD, str(tmp_path_factory.mktemp("gloo")))
    yield w
    w.close()


# --------------------------------------------------------------------------- #
# the table
# --------------------------------------------------------------------------- #
def test_untwinned_entries_are_pinned():
    assert len(INVENTORY) == 95
    assert not UNTWINNED_AFTER_SLICE_14
    assert set(hp.UNTWINNED) == UNTWINNED_AFTER_SLICE_14
    assert len(TWINS) == 95
    assert not hp.REFERENCE_MAKERS  # every twin is its INVENTORY maker, mAP's host-list route included


def test_the_image_stub_twins_share_the_inventory_weights():
    from tests.helpers.inventory import _STUB_FEATURES
    from tests.helpers.torch_twins import STUB_FEATURES

    np.testing.assert_array_equal(STUB_FEATURES.w.numpy(), np.asarray(_STUB_FEATURES.w))


def test_every_buffered_entry_of_a_twin_has_a_buffered_twin():
    for name in NAMES:
        assert (INVENTORY[name].buffered is None) == (TWINS[name].buffered is None), name


@pytest.mark.parametrize("name", NAMES)
def test_hyperparameters_agree(name):
    shared = hp.same_hyperparameters(hp.reference(name), hp.twin(name))
    assert "compute_on_cpu" in shared
    if hp.has_buffered(name):
        assert "buffer_capacity" in hp.same_hyperparameters(hp.reference(name, True), hp.twin(name, True))


@pytest.mark.parametrize("name,kwargs", [
    ("AUROC", dict(num_classes=3)),
    ("AveragePrecision", dict(num_classes=4, average="weighted")),
    ("CalibrationError", dict(n_bins=15)),
    ("AUROC", dict(num_classes=4, buffer_capacity=128)),
])
def test_a_twin_built_with_other_arguments_fails_the_check(name, kwargs):
    with pytest.raises(AssertionError):
        hp.same_hyperparameters(hp.reference(name, "buffer_capacity" in kwargs),
                                getattr(mt_torch, name)(device="cpu", **kwargs))


# --------------------------------------------------------------------------- #
# (a) eager, (b) the engines at their defaults, (c) buffered
# --------------------------------------------------------------------------- #
def _eager(name, buffered):
    ref, twin, want, got = hp.run_eager(name, buffered)
    if name in hp.COMPARE_STATES:
        hp.assert_same_states(ref, twin, name)
    hp.assert_same_result(name, got, want, msg=name)


def _engines(name, buffered):
    run = hp.run_engines(name, buffered)
    ref, twin = run["ref"], run["twin"]
    part = hp.same_partition(ref, twin, name)
    assert hp.counters(twin) == hp.counters(ref), name
    for k, (want, got) in enumerate(run["results"]):
        hp.assert_same_result(name, got, want, msg=f"{name} round {k}")
    if name in hp.COMPARE_STATES:
        hp.assert_same_states(ref, twin, name)
    # the engines change no bit of the port's own eager run
    eager = hp.twin(name, buffered, compiled_update=False, compiled_compute=False)
    for _ in run["results"]:
        for args, kwargs in run["calls"]:
            eager.update(*td.to_torch(args), **td.to_torch(kwargs))
    hp.assert_same_result(name, run["results"][-1][1], eager.compute(), bitwise=True, msg=f"{name} against eager")
    return part, twin


@pytest.mark.parametrize("name", NAMES)
def test_eager_update_compute_parity(name):
    _eager(name, False)


@pytest.mark.parametrize("name", NAMES)
def test_engine_partition_matches_the_jax_engine(name):
    _engines(name, False)


@pytest.mark.parametrize("name", BUFFERED)
def test_buffered_eager_update_compute_parity(name):
    _eager(name, True)


@pytest.mark.parametrize("name", BUFFERED)
def test_buffered_update_is_captured_where_the_jax_update_compiles(name):
    part, twin = _engines(name, True)
    assert INVENTORY[name].buffered_level in ("update_sync", "full")
    # one captured step per signature: KID's `real` routes each batch through
    # its own (bucketed path), so its two values are two captures
    statics = {tuple(sorted(kwargs.items())) for _, kwargs in hp.batches(name)}
    assert part["update"] == (("fused", "compilable") if len(statics) == 1 else (
        "bucketed", "static update kwargs (real) close over per-value jit variants in the per-metric engine"))
    stats = twin.engine_stats()["update"]
    assert stats.cache_misses == len(statics) and stats.cache_hits >= 1


# --------------------------------------------------------------------------- #
# (d) synced, in a gloo world of 4
# --------------------------------------------------------------------------- #
def _holds_array(tree):
    if isinstance(tree, np.ndarray):
        return True
    if isinstance(tree, dict):
        return any(_holds_array(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_holds_array(v) for v in tree)
    return False


def _host_inputs(name):
    """An entry whose calls hold no array anywhere (text corpora, SQuAD's
    dicts): each rank is fed the whole call, and the oracle every rank's copy
    in turn. BERTScore's synced compute is tested in tests/test_torch_bert.py."""
    return name != "BERTScore" and not _holds_array(hp.batches(name))


def _splittable(name):
    """Every positional argument an array whose rows split evenly; keyword
    arguments arrays too, or Python scalars (FID's and KID's ``real``),
    which every rank gets as they are."""
    if _host_inputs(name):
        return True
    for args, kwargs in hp.batches(name):
        arrays = [a for a in (*args, *kwargs.values()) if isinstance(a, np.ndarray)]
        scalars = [v for v in kwargs.values() if isinstance(v, (bool, int, float))]
        if not arrays or len(arrays) + len(scalars) != len(args) + len(kwargs) or arrays[0].shape[0] % WORLD:
            return False
    return True


SYNC_CASES = [(n, False) for n in NAMES if _splittable(n)] + [(n, True) for n in BUFFERED if _splittable(n)]


def _rank_calls(name):
    """Each rank's calls: the rows of every call in WORLD consecutive parts."""
    per_rank = [[] for _ in range(WORLD)]
    for args, kwargs in hp.batches(name):
        split = lambda a: np.split(a, WORLD) if isinstance(a, np.ndarray) else [a] * WORLD  # noqa: E731
        parts = [split(a) for a in args]
        kparts = {k: split(v) for k, v in kwargs.items()}
        for r in range(WORLD):
            per_rank[r].append((tuple(p[r] for p in parts), {k: v[r] for k, v in kparts.items()}))
    return per_rank


def _rank_seed(name, rank):
    """The seed of rank ``rank``'s generator for a ``SEEDED`` entry, else None."""
    return hp.SEEDED[name] + rank if name in hp.SEEDED else None


def _oracle(name, buffered, per_rank, **kwargs):
    metric = make_twin(name, buffered, **kwargs)
    for rank, calls in enumerate(per_rank):
        # each rank's resampling comes from its own generator
        hp.seed_generator(name, metric, _rank_seed(name, rank))
        for args, kwargs in calls:
            metric.update(*td.to_torch(args), **td.to_torch(kwargs))
    return metric.compute()


def test_every_array_entry_has_a_sync_case():
    assert {n for n, _ in SYNC_CASES} == set(NAMES) - {"MeanAveragePrecision", "BERTScore"}


@pytest.mark.parametrize("name,buffered", SYNC_CASES)
def test_synced_compute_matches_the_rank_major_oracle(world, name, buffered):
    per_rank = _rank_calls(name)
    # a compute that draws host indices draws them from the same seed on every rank
    kwargs = {"seed": hp.SEEDED_COMPUTE[name]} if name in hp.SEEDED_COMPUTE else None
    results = world.run(td.twin_synced_compute,
                        [(name, buffered, calls, kwargs, _rank_seed(name, r)) for r, calls in enumerate(per_rank)])
    want = _oracle(name, buffered, per_rank, **(kwargs or {}))
    # a float32 sum state adds the ranks' partial sums in the collective's
    # order, not the oracle's batch order: equal within the bound
    bitwise = name not in hp.FLOAT_SUM_STATES
    for rank, got in enumerate(results):
        hp.assert_same_result(name, got, want, bitwise=bitwise, msg=f"{name} rank {rank}")


def test_buffered_map_synced_compute_matches_the_rank_major_oracle(world):
    rng = np.random.default_rng(808)
    per_rank = []
    for _ in range(WORLD):
        calls = []
        for _ in range(3):  # one eager call, one capture, one replay
            preds, targets = coco_dataset(rng, 4)
            calls.append(((preds, targets), {}))
        per_rank.append(calls)
    # 16 images hold a rank's 12, so the captured appends stay in bounds; the
    # buffers are the device route's (the twin's default is the host lists)
    kwargs = dict(device_state=True, buffer_capacity=16, class_metrics=True)
    results = world.run(td.twin_synced_compute, [("MeanAveragePrecision", False, calls, kwargs) for calls in per_rank])
    want = _oracle("MeanAveragePrecision", False, per_rank, **{**kwargs, "buffer_capacity": 64})
    for rank, got in enumerate(results):
        hp.assert_same_result("MeanAveragePrecision", got, want, bitwise=True, msg=f"rank {rank}")

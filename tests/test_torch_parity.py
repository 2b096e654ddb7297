"""The factory parity harness over every ``INVENTORY`` entry with a port twin.

``tests/helpers/torch_parity.py`` builds both twins from one entry (the
twin table is ``tests/helpers/torch_twins.py``) and runs the checks this
module parametrizes over the first half of the entries
(``hp.PARITY_PARTS[0]``; ``tests/test_torch_parity_part2.py`` takes the
second): hyperparameters, (a) eager parity, (b) the engine partition at the
defaults, (c) the buffered factory, and (d) the synced compute in one gloo
world of 4 ranks for the module, against the rank-major oracle (the same
twin fed every rank's rows in rank order), bit for bit.

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
from tests.helpers.torch_twins import TWINS

NAMES = sorted(TWINS)
WORLD = hp.WORLD

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


@pytest.mark.parametrize("name", hp.PARITY_PARTS[0])
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
# (a) eager, (b) the engines at their defaults, (c) buffered, (d) synced:
# the first half of the entries (the second is tests/test_torch_parity_part2.py)
# --------------------------------------------------------------------------- #
PART = hp.PARITY_PARTS[0]


@pytest.mark.parametrize("name", PART)
def test_eager_update_compute_parity(name):
    hp.check_eager(name, False)


@pytest.mark.parametrize("name", PART)
def test_engine_partition_matches_the_jax_engine(name):
    hp.check_engines(name, False)


@pytest.mark.parametrize("name", [n for n in PART if hp.has_buffered(n)])
def test_buffered_eager_update_compute_parity(name):
    hp.check_eager(name, True)


@pytest.mark.parametrize("name", [n for n in PART if hp.has_buffered(n)])
def test_buffered_update_is_captured_where_the_jax_update_compiles(name):
    hp.check_buffered_capture(name)


def test_every_array_entry_has_a_sync_case():
    cases = hp.sync_cases(hp.PARITY_PARTS[0]) + hp.sync_cases(hp.PARITY_PARTS[1])
    assert {n for n, _ in cases} == set(NAMES) - {"MeanAveragePrecision", "BERTScore"}
    assert hp.PARITY_PARTS[0] + hp.PARITY_PARTS[1] == NAMES


@pytest.mark.parametrize("name,buffered", hp.sync_cases(PART))
def test_synced_compute_matches_the_rank_major_oracle(world, name, buffered):
    hp.check_synced(world, name, buffered)


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
    want = hp.oracle("MeanAveragePrecision", False, per_rank, **{**kwargs, "buffer_capacity": 64})
    for rank, got in enumerate(results):
        hp.assert_same_result("MeanAveragePrecision", got, want, bitwise=True, msg=f"rank {rank}")

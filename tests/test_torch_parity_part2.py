"""The factory parity harness over the second half of the ``INVENTORY``
entries with a port twin (``hp.PARITY_PARTS[1]``): the checks of
``tests/test_torch_parity.py``, which holds the table and the first half,
parametrized over the rest, so that ``--dist loadfile`` runs the halves on
two workers: hyperparameters, (a) eager parity, (b) the engine partition at
the defaults, (c) the buffered factory, (d) the synced compute in one gloo
world of 4 ranks for the module against the rank-major oracle. The bounds
are the harness's (``RTOL``/``ATOL`` = 1e-6 for float sums, bit for bit
elsewhere).
"""
import pytest

import metrics_tpu as mt_jax
import metrics_tpu_torch as mt_torch
from tests.helpers import torch_dist as td
from tests.helpers import torch_parity as hp
from tests.helpers.torch_port import local_punkt_only, one_torch_thread  # noqa: F401

PART = hp.PARITY_PARTS[1]

# one torch thread, as in tests/test_torch_parity.py (torch 2.13.0+cpu's MKL
# hangs in SDR's batched LU after a module restored several threads)
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
    w = td.GlooWorld(hp.WORLD, str(tmp_path_factory.mktemp("gloo")))
    yield w
    w.close()


@pytest.mark.parametrize("name", PART)
def test_hyperparameters_agree(name):
    shared = hp.same_hyperparameters(hp.reference(name), hp.twin(name))
    assert "compute_on_cpu" in shared
    if hp.has_buffered(name):
        assert "buffer_capacity" in hp.same_hyperparameters(hp.reference(name, True), hp.twin(name, True))


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


@pytest.mark.parametrize("name,buffered", hp.sync_cases(PART))
def test_synced_compute_matches_the_rank_major_oracle(world, name, buffered):
    hp.check_synced(world, name, buffered)

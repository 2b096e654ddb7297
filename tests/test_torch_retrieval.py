"""The retrieval slice of the port against the JAX package:
``metrics_tpu_torch/ops/retrieval/`` (the single-query functionals and the
compiled ``segmented`` evaluation), ``metrics_tpu_torch/retrieval/`` and the
retrieval input checks and query grouping of ``utils/``.

The same seeded numpy inputs go to both packages: ragged queries with tied
scores (rounded through float16), queries with no positive and with no
negative document, graded relevance for nDCG. Scalar results are held within
1e-5, the JAX package's bound for both evaluation paths
(``tests/retrieval/test_option_grid.py:202``); the dense matrices, masks and
overflow flags of ``bucketize_queries`` and the grouping bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt_jax
import metrics_tpu.ops as ops_jax
import metrics_tpu_torch as mt_torch
import metrics_tpu_torch.ops as ops_torch
from metrics_tpu.ops.retrieval import segmented as seg_jax
from metrics_tpu.utils.data import get_group_indexes as jax_groups
from metrics_tpu.utils.exceptions import MetricsUserError as JaxUserError
from metrics_tpu_torch.ops.retrieval import segmented as seg_torch
from metrics_tpu_torch.retrieval.precision_recall_curve import _retrieval_recall_at_fixed_precision
from metrics_tpu_torch.utils.checks import _checks_off
from metrics_tpu_torch.utils.data import get_group_indexes
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from tests.helpers.torch_port import assert_bitwise, assert_close

BOUND = 1e-5

pytestmark = pytest.mark.filterwarnings("ignore")


def _stream(seed, n=180, n_queries=14, graded=False, shuffle=True):
    """Ragged queries (1 to about 25 documents), ties in the scores, query 0
    with no positive document, query 1 with no negative one."""
    rng = np.random.default_rng(seed)
    indexes = rng.integers(0, n_queries, n).astype(np.int32)
    if not shuffle:
        indexes = np.sort(indexes)
    preds = (np.round(rng.random(n) * 16).astype(np.float16).astype(np.float32)) / 16
    target = rng.integers(0, 4, n) if graded else (rng.random(n) < 0.3).astype(np.int64)
    target[indexes == 0] = 0
    target[indexes == 1] = 1 if not graded else 2
    return preds, target, indexes


def _query(seed, n=23, graded=False):
    rng = np.random.default_rng(seed)
    preds = (np.round(rng.random(n) * 8).astype(np.float16).astype(np.float32)) / 8
    target = rng.integers(0, 3, n) if graded else (rng.random(n) < 0.4).astype(np.int64)
    return preds, target


def _close(got, want, bound=BOUND):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    assert_close(got.astype(np.float64), want.astype(np.float64), rtol=bound, atol=bound)


def _t(*arrays):
    return [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# --------------------------------------------------------------------------- #
# single-query functionals
# --------------------------------------------------------------------------- #
FUNCTIONALS = [
    ("retrieval_average_precision", {}),
    ("retrieval_reciprocal_rank", {}),
    ("retrieval_precision", {}),
    ("retrieval_precision", {"k": 4}),
    ("retrieval_precision", {"k": 40}),
    ("retrieval_precision", {"k": 40, "adaptive_k": True}),
    ("retrieval_recall", {}),
    ("retrieval_recall", {"k": 5}),
    ("retrieval_hit_rate", {"k": 1}),
    ("retrieval_hit_rate", {"k": 3}),
    ("retrieval_fall_out", {}),
    ("retrieval_fall_out", {"k": 6}),
    ("retrieval_normalized_dcg", {}),
    ("retrieval_normalized_dcg", {"k": 5}),
    ("retrieval_r_precision", {}),
]


@pytest.mark.parametrize("seed", (1, 2, 3))
@pytest.mark.parametrize("name,kwargs", FUNCTIONALS, ids=[f"{n}-{kw}" for n, kw in FUNCTIONALS])
def test_single_query_functionals(name, kwargs, seed):
    preds, target = _query(seed, graded=name == "retrieval_normalized_dcg" and seed == 3)
    if seed == 2:
        target[:] = 0  # no positive document
    got = getattr(ops_torch, name)(*_t(preds, target), **kwargs)
    want = getattr(ops_jax, name)(*_j(preds, target), **kwargs)
    _close(got, want)


def test_tied_scores_keep_their_input_order():
    """All scores tie: the stable ranking keeps the input order, so AP and RR
    are those of the target as given."""
    preds = np.full(6, 0.5, np.float32)
    target = np.array([0, 0, 1, 0, 1, 1])
    for name, want in (("retrieval_reciprocal_rank", 1 / 3), ("retrieval_average_precision", (1 / 3 + 2 / 5 + 3 / 6) / 3)):
        got = getattr(ops_torch, name)(*_t(preds, target))
        _close(got, getattr(ops_jax, name)(*_j(preds, target)))
        assert abs(float(got) - want) < 1e-6


@pytest.mark.parametrize("max_k,adaptive_k", [(None, False), (4, False), (30, False), (30, True)])
def test_precision_recall_curve_functional(max_k, adaptive_k):
    preds, target = _query(5)
    got = ops_torch.retrieval_precision_recall_curve(*_t(preds, target), max_k=max_k, adaptive_k=adaptive_k)
    want = ops_jax.retrieval_precision_recall_curve(*_j(preds, target), max_k=max_k, adaptive_k=adaptive_k)
    for g, w in zip(got[:2], want[:2]):
        _close(g, w)
    assert_bitwise(got[2], want[2], "top_k")


def test_functional_input_errors():
    p, t = _t(np.zeros(3, np.float32), np.array([0, 1, 2]))
    with pytest.raises(ValueError, match="binary"):
        ops_torch.retrieval_average_precision(p, t)
    with pytest.raises(ValueError, match="float scores"):
        ops_torch.retrieval_recall(t, t)
    with pytest.raises(ValueError, match="shapes must match"):
        ops_torch.retrieval_recall(p, t[:2])
    with pytest.raises(ValueError, match="non-scalar"):
        ops_torch.retrieval_recall(p[:0], t[:0])
    with pytest.raises(ValueError, match="positive integer"):
        ops_torch.retrieval_precision(p, t.clamp(max=1), k=0)
    with pytest.raises(ValueError, match="boolean"):
        ops_torch.retrieval_precision(p, t.clamp(max=1), adaptive_k=1)
    with _checks_off():  # a captured step reads nothing back: no binary check
        ops_torch.retrieval_average_precision(p, t)


def test_group_indexes_first_seen_order():
    _, _, indexes = _stream(7)
    got = get_group_indexes(torch.from_numpy(indexes))
    want = jax_groups(jnp.asarray(indexes))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_bitwise(g, w, "group")


# --------------------------------------------------------------------------- #
# the compiled path: bucketize_queries and the row scorers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("bounds", [(16, 32), (16, 8), (9, 32), (9, 8), (14, 25)],
                         ids=["large", "few-docs", "few-queries", "both-small", "exact"])
@pytest.mark.parametrize("with_valid", (False, True))
def test_bucketize_queries_against_jax(bounds, with_valid):
    preds, target, indexes = _stream(8)
    valid = None
    if with_valid:  # a buffer's row mask: its tail is not data
        valid = np.arange(len(indexes)) < 150
    q, d = bounds
    got = seg_torch.bucketize_queries(*_t(indexes, preds, target.astype(np.int32)),
                                      None if valid is None else torch.from_numpy(valid), q, d)
    want = seg_jax.bucketize_queries(*_j(indexes, preds, target.astype(np.int32)),
                                     None if valid is None else jnp.asarray(valid), q, d)
    for name, g, w in zip(("P", "T", "M", "query_mask", "overflow"), got, want):
        assert_bitwise(g, w, name)
    assert bool(got[4]) == (bounds != (16, 32) and bounds != (14, 25))


ROWS = [
    ("average_precision_rows", "retrieval_average_precision", {}),
    ("reciprocal_rank_rows", "retrieval_reciprocal_rank", {}),
    ("precision_rows", "retrieval_precision", {}),
    ("precision_rows", "retrieval_precision", {"k": 3}),
    ("precision_rows", "retrieval_precision", {"k": 9, "adaptive_k": True}),
    ("recall_rows", "retrieval_recall", {}),
    ("recall_rows", "retrieval_recall", {"k": 3}),
    ("hit_rate_rows", "retrieval_hit_rate", {"k": 2}),
    ("fall_out_rows", "retrieval_fall_out", {"k": 3}),
    ("normalized_dcg_rows", "retrieval_normalized_dcg", {}),
    ("normalized_dcg_rows", "retrieval_normalized_dcg", {"k": 4}),
    ("r_precision_rows", "retrieval_r_precision", {}),
]


@pytest.mark.parametrize("rows,functional,kwargs", ROWS, ids=[f"{r}-{kw}" for r, _, kw in ROWS])
def test_row_scorers_against_the_eager_functional_and_jax(rows, functional, kwargs):
    graded = rows == "normalized_dcg_rows"
    preds, target, indexes = _stream(9, graded=graded)
    target = target.astype(np.int32)
    mats = seg_torch.bucketize_queries(*_t(indexes, preds, target), None, 16, 32)
    got = getattr(seg_torch, rows)(*mats[:3], **kwargs)
    want = getattr(seg_jax, rows)(*seg_jax.bucketize_queries(*_j(indexes, preds, target), None, 16, 32)[:3], **kwargs)
    _close(got, want)
    # row r is the r-th distinct query id in ascending order
    for r, q in enumerate(np.unique(indexes)):
        sel = indexes == q
        eager = getattr(ops_torch, functional)(*_t(preds[sel], target[sel]), **kwargs)
        _close(got[r], eager.numpy())


@pytest.mark.parametrize("action", ("neg", "pos", "skip"))
def test_segmented_mean_against_jax(action):
    rng = np.random.default_rng(10)
    scores = rng.random(12).astype(np.float32)
    empty = rng.random(12) < 0.3
    qmask = np.arange(12) < 9
    got = seg_torch.segmented_mean(*_t(scores, empty, qmask), action)
    want = seg_jax.segmented_mean(*_j(scores, empty, qmask), action)
    _close(got, want)


# --------------------------------------------------------------------------- #
# the classes: both paths, the empty_target_action x ignore_index grid
# --------------------------------------------------------------------------- #
SCALARS = [
    ("RetrievalMAP", {}),
    ("RetrievalMRR", {}),
    ("RetrievalPrecision", {"k": 3}),
    ("RetrievalPrecision", {"k": 9, "adaptive_k": True}),
    ("RetrievalRecall", {"k": 3}),
    ("RetrievalHitRate", {"k": 2}),
    ("RetrievalFallOut", {"k": 3}),
    ("RetrievalNormalizedDCG", {"k": 4}),
    ("RetrievalRPrecision", {}),
]
SCALAR_IDS = [f"{n}-{kw}" for n, kw in SCALARS]


def _feed(metric, preds, target, indexes, to, batches=3):
    for chunk in np.array_split(np.arange(len(indexes)), batches):
        p, t, i = to(preds[chunk], target[chunk], indexes[chunk])
        metric.update(p, t, indexes=i)


def _ignored_stream(seed, ignore_index):
    preds, target, indexes = _stream(seed, n=90, n_queries=8)
    if ignore_index is not None:
        rng = np.random.default_rng(seed + 100)
        target = np.where(rng.random(len(target)) < 0.15, ignore_index, target)
    return preds, target, indexes


@pytest.mark.parametrize("ignore_index", (None, -100))
@pytest.mark.parametrize("action", ("neg", "pos", "skip", "error"))
@pytest.mark.parametrize("name,kwargs", SCALARS, ids=SCALAR_IDS)
def test_eager_path_grid(name, kwargs, action, ignore_index):
    preds, target, indexes = _ignored_stream(11, ignore_index)
    ref = getattr(mt_jax, name)(empty_target_action=action, ignore_index=ignore_index, **kwargs)
    twin = getattr(mt_torch, name)(empty_target_action=action, ignore_index=ignore_index, device="cpu", **kwargs)
    _feed(ref, preds, target, indexes, _j, batches=2)
    _feed(twin, preds, target, indexes, _t, batches=2)
    if action == "error":  # query 0 has no positive document, query 1 no negative one
        for metric in (ref, twin):
            with pytest.raises(ValueError, match="no (positive|negative) target"):
                metric.compute()
        return
    _close(twin.compute(), ref.compute())


@pytest.mark.parametrize("ignore_index", (None, -100))
@pytest.mark.parametrize("action", ("neg", "pos", "skip"))
@pytest.mark.parametrize("name,kwargs", SCALARS, ids=SCALAR_IDS)
def test_compiled_path_grid(name, kwargs, action, ignore_index):
    """Static bounds: the port's buffered, captured path (on the CPU, its
    steady-state step) against the JAX package's segmented evaluation of the
    same rows, and against the port's own eager path."""
    preds, target, indexes = _ignored_stream(12, ignore_index)
    bounds = dict(max_queries=16, max_docs_per_query=32)
    common = dict(empty_target_action=action, ignore_index=ignore_index, **kwargs)
    ref = getattr(mt_jax, name)(**bounds, **common)
    twin = getattr(mt_torch, name)(device="cpu", buffer_capacity=128, **bounds, **common)
    eager = getattr(mt_torch, name)(device="cpu", **common)
    _feed(ref, preds, target, indexes, _j, batches=2)
    _feed(eager, preds, target, indexes, _t, batches=2)
    _feed(twin, preds, target, indexes, _t, batches=3)  # the third update is captured
    got = [twin.compute() for _ in range(3)]  # warmup, capture, replay
    want = ref.compute()
    for value in got:
        _close(value, want)
    _close(got[-1], eager.compute().numpy())
    if ignore_index is None:  # ignore_index filters rows: a shape that depends on values, so eager
        assert twin.engine_stats()["update"].cache_misses == 1


def test_fall_out_inverts_emptiness():
    """Query 1 has no negative document: FallOut counts it as empty (and
    query 0, with no positive one, as a normal query), on both paths."""
    preds, target, indexes = _stream(13)
    for action, wants_error in (("error", True), ("skip", False)):
        ref = mt_jax.RetrievalFallOut(empty_target_action=action)
        twin = mt_torch.RetrievalFallOut(empty_target_action=action, device="cpu")
        _feed(ref, preds, target, indexes, _j)
        _feed(twin, preds, target, indexes, _t)
        if wants_error:
            for metric in (ref, twin):
                with pytest.raises(ValueError, match="no negative target"):
                    metric.compute()
            continue
        _close(twin.compute(), ref.compute())
    keep = indexes != 1  # without the all-positive query nothing is empty for FallOut
    results = {}
    for action in ("neg", "pos", "skip"):
        for path in ({}, {"max_queries": 16, "max_docs_per_query": 32}):
            twin = mt_torch.RetrievalFallOut(empty_target_action=action, device="cpu", **path)
            _feed(twin, preds[keep], target[keep], indexes[keep], _t)
            results[(action, bool(path))] = float(twin.compute())
    assert len({round(v, 6) for v in results.values()}) == 1, results
    rows = seg_torch.bucketize_queries(*_t(indexes, preds, target.astype(np.int32)), None, 16, 32)
    empty = mt_torch.RetrievalFallOut(device="cpu")._empty_rows(rows[1], rows[2]) & rows[3]
    assert empty.nonzero().flatten().tolist() == [1]  # row 1 is query id 1


@pytest.mark.parametrize("max_k,adaptive_k", [(4, False), (None, False), (30, True)])
@pytest.mark.parametrize("action", ("neg", "pos", "skip"))
def test_precision_recall_curve_classes(action, max_k, adaptive_k):
    """The curves within 1e-5 of the JAX package's. RecallAtFixedPrecision's
    recall and k are those of the port's own curve; its k equals the JAX
    package's unless a mean precision lies within the bound of the floor,
    where one float32 rounding of the mean decides whether that k qualifies
    (precision at k = 15 is 0.30000004 there and 0.29999998 here for one
    case of this grid)."""
    preds, target, indexes = _stream(14, n=120, n_queries=10)
    min_precision = 0.3
    common = dict(max_k=max_k, adaptive_k=adaptive_k, empty_target_action=action)
    ref = mt_jax.RetrievalPrecisionRecallCurve(**common)
    twin = mt_torch.RetrievalPrecisionRecallCurve(device="cpu", **common)
    at_ref = mt_jax.RetrievalRecallAtFixedPrecision(min_precision=min_precision, **common)
    at_twin = mt_torch.RetrievalRecallAtFixedPrecision(min_precision=min_precision, device="cpu", **common)
    for metric, to in ((ref, _j), (twin, _t), (at_ref, _j), (at_twin, _t)):
        _feed(metric, preds, target, indexes, to, batches=2)
    (p, r, k), (pw, rw, kw) = twin.compute(), ref.compute()
    _close(p, pw)
    _close(r, rw)
    assert_bitwise(k, kw, "top_k")
    got, want = at_twin.compute(), at_ref.compute()
    own = _retrieval_recall_at_fixed_precision(p, r, k, min_precision)
    for g, o in zip(got, own):
        assert_bitwise(g, o, "recall at fixed precision from the port's curve")
    _close(got[0], want[0])
    if not (np.abs(np.asarray(pw, np.float64) - min_precision) <= BOUND).any():
        assert_bitwise(got[1], want[1], "best k")


def test_overflow_is_reported_as_in_the_jax_package():
    preds, target, indexes = _stream(15)
    small = dict(max_queries=8, max_docs_per_query=32)
    ref = mt_jax.RetrievalMAP(**small)
    twin = mt_torch.RetrievalMAP(device="cpu", **small)
    _feed(ref, preds, target, indexes, _j)
    _feed(twin, preds, target, indexes, _t)
    with pytest.raises(JaxUserError, match="overflowed its static bounds"):
        ref.compute()
    with pytest.raises(MetricsUserError, match="overflowed its static bounds"):
        twin.compute()
    with _checks_off():  # a captured compute reads nothing back: NaN
        assert torch.isnan(twin.compute_state(twin.get_state()))


def test_buffer_overflow_poisons_the_compiled_compute():
    """A captured update past the buffer's capacity: compute() raises eager,
    a captured compute gives NaN, as the JAX package's do."""
    preds, target, indexes = _stream(16, n=96)
    twin = mt_torch.RetrievalMAP(device="cpu", max_queries=16, max_docs_per_query=32, buffer_capacity=64)
    for chunk in np.array_split(np.arange(96), 3):  # the third update is replayed past the capacity
        twin.update(*_t(preds[chunk], target[chunk]), indexes=_t(indexes[chunk])[0])
    assert twin.indexes.overflow_seen
    with pytest.raises(MetricsUserError, match="overflowed its buffer_capacity"):
        twin.compute()
    with _checks_off():
        assert torch.isnan(twin.compute_state(twin.get_state()))


def test_constructor_errors_match():
    for mt in (mt_jax, mt_torch):
        kw = {} if mt is mt_jax else {"device": "cpu"}
        with pytest.raises(ValueError, match="set together"):
            mt.RetrievalMAP(max_queries=4, **kw)
        with pytest.raises(ValueError, match="positive integers"):
            mt.RetrievalMAP(max_queries=0, max_docs_per_query=4, **kw)
        with pytest.raises(ValueError, match="incompatible"):
            mt.RetrievalMAP(empty_target_action="error", max_queries=4, max_docs_per_query=4, **kw)
        with pytest.raises(ValueError, match="empty_target_action"):
            mt.RetrievalMAP(empty_target_action="drop", **kw)
        with pytest.raises(ValueError, match="ignore_index"):
            mt.RetrievalMAP(ignore_index=0.5, **kw)
        with pytest.raises(ValueError, match="`k`"):
            mt.RetrievalPrecision(k=0, **kw)
        with pytest.raises(ValueError, match="min_precision"):
            mt.RetrievalRecallAtFixedPrecision(min_precision=2.0, **kw)
        with pytest.raises(ValueError, match="indexes"):
            mt.RetrievalMAP(**kw).update(*(_j if mt is mt_jax else _t)(np.zeros(3, np.float32), np.zeros(3, np.int32)),
                                         indexes=None)


def test_states_are_int32_and_float32_as_in_the_jax_package():
    preds, target, indexes = _stream(17)
    ref = mt_jax.RetrievalNormalizedDCG()
    twin = mt_torch.RetrievalNormalizedDCG(device="cpu")
    _feed(ref, preds, target.astype(np.float64), indexes.astype(np.int64), _j)
    _feed(twin, preds, target.astype(np.float64), indexes.astype(np.int64), _t)
    for key in ("indexes", "preds", "target"):
        for g, w in zip(getattr(twin, key), getattr(ref, key)):
            assert_bitwise(g, w, key)

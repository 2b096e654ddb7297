"""The factory parity harness: one ``INVENTORY`` entry, two twins.

For each entry of ``tests/helpers/inventory.py`` that has a port twin
(``tests/helpers/torch_twins.py``), the harness builds the JAX package's
metric from the entry and the port's from the twin table with the same
constructor arguments, turns the entry's ``batch()`` into numpy and then into
CPU tensors, and compares:

- the public hyperparameters both objects carry (:func:`hyperparameters`);
- (a) eager ``update`` then ``compute``: the states bit for bit (integer
  states, float states that are copies of the inputs, ``CatBuffer`` rows,
  counts and flags), the results bit for bit where ``BITWISE_RESULTS`` says
  the JAX package's are exact and within ``RTOL``/``ATOL`` elsewhere;
- (b) the same with the engines at their defaults, one update then one
  compute per round: each kind's path and revert reason equal the JAX
  engine's ``engine_stats()["partition"]`` (:func:`same_partition`), the
  counters equal too, the results equal the eager run's bit for bit;
- (c) the ``buffered`` factory under (a) and (b), its update captured where
  the entry's ``buffered_level`` says the JAX update compiles.

The synced case (d) runs in the gloo world of ``tests/helpers/torch_dist.py``.
The checks are here as functions; ``tests/test_torch_parity.py`` and
``tests/test_torch_parity_part2.py`` parametrize them over the two halves of
:data:`PARITY_PARTS`, so that ``--dist loadfile`` runs the halves on two
workers. :data:`UNTWINNED` lists the entries that have no twin yet.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np
import torch

import metrics_tpu as M
from metrics_tpu.core.buffers import CatBuffer as JaxCatBuffer
from metrics_tpu.sketches import is_sketch as is_jax_sketch
from metrics_tpu_torch.core.buffers import CatBuffer
from tests.helpers.inventory import INVENTORY
from tests.helpers.torch_dist import to_torch
from tests.helpers.torch_port import assert_bitwise, assert_close
from tests.helpers.torch_twins import C, TWINS, make_twin

# the stated bound for scalar results that are float sums (means, trapezoids,
# weighted bin sums), summed in XLA's order by the JAX package
RTOL = 1e-6
ATOL = 1e-6

# results that are exact in both packages: integer counts and their ratios,
# binned curve points, and exact curve points (integer cumulative sums, one
# IEEE division each); an average precision is a sum of products
BITWISE_RESULTS = frozenset({
    "StatScores", "Accuracy", "Precision", "Recall", "F1Score", "FBetaScore",
    "BinnedPrecisionRecallCurve", "BinnedRecallAtFixedPrecision",
    "MeanAveragePrecision", "ROC", "PrecisionRecallCurve",
    # integer matrices and counts, ratios of them, maxima and copied rows
    "ConfusionMatrix", "JaccardIndex", "Specificity", "Dice", "HammingDistance",
    "MaxMetric", "MinMetric", "CatMetric",
})

# float32 states that are sums over a batch (hinge margins, divergences,
# ranking scores, aggregated values): XLA and torch sum in different orders,
# so these states are compared within RTOL/ATOL, not bit for bit; their
# integer states (counts, totals) still compare bitwise
FLOAT_SUM_STATES = frozenset({
    "HingeLoss", "KLDivergence", "CoverageError", "LabelRankingAveragePrecision", "LabelRankingLoss",
    "SumMetric", "MeanMetric",
    # the regression error sums and running moments (Pearson's merge across
    # ranks is a different sum from one rank's sequential updates), and the
    # composition of MSE and MAE
    "MeanSquaredError", "MeanAbsoluteError", "MeanSquaredLogError", "MeanAbsolutePercentageError",
    "SymmetricMeanAbsolutePercentageError", "WeightedMeanAbsolutePercentageError", "R2Score",
    "ExplainedVariance", "TweedieDevianceScore", "PearsonCorrCoef", "CompositionalMetric",
    # the wrappers over MeanSquaredError: BootStrapper's stacked sums, the
    # min and max of MSE values, and the per-output MSE results
    "BootStrapper", "MinMaxMetric", "MultioutputWrapper",
    # image: PSNR's error sum, FID's Welford triples, LPIPS's score sum, and
    # the stub features of KID and IS (a matmul, summed in another order)
    "PeakSignalNoiseRatio", "FrechetInceptionDistance", "LearnedPerceptualImagePatchSimilarity",
    "KernelInceptionDistance", "InceptionScore",
    # audio: the per-sample values are float32 sums over time (STOI's over
    # bands and segments, SDR's through its FFTs and solve), summed in
    # another order than XLA's; ``total`` stays bitwise. SI-SNR's and PESQ's
    # sums come out bit for bit on the INVENTORY's inputs and stay bitwise
    "SignalNoiseRatio", "ScaleInvariantSignalDistortionRatio", "SignalDistortionRatio",
    "PermutationInvariantTraining", "ShortTimeObjectiveIntelligibility",
})

# entries held to a wider bound than RTOL/ATOL, each with its reason: FID's
# Welford M2 adds an outer product of mean deltas at every Chan combine, in
# another order than XLA's (up to 2e-6 relative apart after 4 rounds): 1e-5
ENTRY_TOLERANCE = {"FrechetInceptionDistance": (1e-5, 1e-5)}


def tolerance(name: str) -> Tuple[float, float]:
    """``(rtol, atol)`` for the entry's float comparisons."""
    return ENTRY_TOLERANCE.get(name, (RTOL, ATOL))


# entries whose maker draws from an unseeded generator (BootStrapper's
# resample indices): both twins get a generator made from this seed after
# construction, so they resample the same rows
SEEDED = {"BootStrapper": 20261017}

# entries whose compute draws from ``np.random.default_rng(self.seed)`` with
# the INVENTORY's ``seed=None`` (KID's subsets, IS's permutation): both twins
# get this seed, every rank too, so they draw the same indices
SEEDED_COMPUTE = {"KernelInceptionDistance": 20261017, "InceptionScore": 20261017}

# states compared bit for bit; BERTScore's are host token arrays that the
# two packages pack differently (compared through its results)
COMPARE_STATES = frozenset(TWINS) - {"BERTScore"}

# where the INVENTORY maker builds what the port has not ported, the
# reference side builds what the twin builds (none left: every twin is its
# INVENTORY maker)
REFERENCE_MAKERS: Dict[str, Any] = {}

UNTWINNED = frozenset(INVENTORY) - frozenset(TWINS)

# a runtime revert names the exception, which differs between the packages
# (a jit trace error there, Uncapturable here): the reasons compare by kind
_RUNTIME = "runtime fallback"
# the JAX package names the heavy kernels a class declares (analysis
# metadata the port has not ported, ROADMAP A21)
_HEAVY = "; heavy kernels declared:"


def has_buffered(name: str) -> bool:
    return INVENTORY[name].buffered is not None and TWINS[name].buffered is not None


def seed_generator(name: str, metric: Any, seed: Optional[int] = None) -> Any:
    """``metric`` with the host generator of a ``SEEDED`` entry remade from
    ``seed`` (the entry's own by default); other entries pass unchanged."""
    if name in SEEDED:
        metric._rng = np.random.default_rng(SEEDED[name] if seed is None else seed)
    if name in SEEDED_COMPUTE:
        metric.seed = SEEDED_COMPUTE[name]
    return metric


def reference(name: str, buffered: bool = False) -> Any:
    entry = INVENTORY[name]
    if buffered:
        return seed_generator(name, entry.buffered())
    return seed_generator(name, REFERENCE_MAKERS.get(name, entry.make)())


def twin(name: str, buffered: bool = False, **kwargs: Any) -> Any:
    """The port twin, seeded as :func:`reference` seeds its side."""
    return seed_generator(name, make_twin(name, buffered, **kwargs))


def _numpy(tree: Any) -> Any:
    if isinstance(tree, (jnp.ndarray, np.ndarray)):
        return np.array(tree)
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    return tree


def batches(name: str) -> List[Tuple[tuple, dict]]:
    """The entry's update calls, as numpy: ``[(args, kwargs), ...]``."""
    out = INVENTORY[name].batch()
    calls = out if isinstance(out, list) else [out]
    return [(_numpy(tuple(args)), _numpy(dict(kwargs))) for args, kwargs in calls]


def _jax(tree: Any) -> Any:
    if isinstance(tree, np.ndarray):
        return jnp.asarray(tree)
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_jax(v) for v in tree)
    return tree


def update_both(ref: Any, twin: Any, calls: List[Tuple[tuple, dict]]) -> None:
    for args, kwargs in calls:
        ref.update(*_jax(args), **_jax(kwargs))
        twin.update(*to_torch(args), **to_torch(kwargs))


# --------------------------------------------------------------------------- #
# hyperparameters
# --------------------------------------------------------------------------- #
_SCALARS = (bool, int, float, str, type(None))


def hyperparameters(metric: Any) -> Dict[str, Any]:
    """The public, non-state scalar and str attributes (enums by value)."""
    out = {}
    for key, value in vars(metric).items():
        if key.startswith("_") or key in metric._defaults or not isinstance(value, _SCALARS):
            continue
        out[key] = value.value if hasattr(value, "value") else value
    return out


def same_hyperparameters(ref: Any, twin: Any) -> List[str]:
    """The shared hyperparameters, asserted equal; returns their names."""
    a, b = hyperparameters(ref), hyperparameters(twin)
    shared = sorted(set(a) & set(b))
    assert shared, "the twins share no hyperparameter"
    assert {k: a[k] for k in shared} == {k: b[k] for k in shared}
    return shared


# --------------------------------------------------------------------------- #
# states and results
# --------------------------------------------------------------------------- #
def assert_same_states(ref: Any, twin: Any, msg: str = "") -> None:
    """Every registered state of the twin against the reference's, bit for
    bit; float states of a ``FLOAT_SUM_STATES`` entry within RTOL/ATOL."""
    assert set(twin._defaults) == set(ref._defaults), msg
    close = msg in FLOAT_SUM_STATES
    for key in ref._defaults:
        want, got = getattr(ref, key), getattr(twin, key)
        where = f"{msg}: state {key!r}"
        if close and isinstance(got, torch.Tensor) and got.is_floating_point():
            _assert_float32_close(got, want, where, *tolerance(msg))
            continue
        if is_jax_sketch(want):
            assert type(got).__name__ == type(want).__name__ and got.config_dict() == want.config_dict(), where
            for comp, value in want.components().items():
                assert_bitwise(getattr(got, comp), np.asarray(value), f"{where} component {comp!r}")
        elif isinstance(want, JaxCatBuffer):
            assert isinstance(got, CatBuffer), where
            assert got.capacity == want.capacity, where
            assert_bitwise(got.count, np.asarray(want.count), where + " count")
            assert_bitwise(got.overflowed, np.asarray(want.overflowed), where + " overflowed")
            assert len(got) == int(want.count) and got.overflow_seen == bool(want.overflowed), where + " mirrors"
            if want.materialized:
                rows = got.data[: min(len(got), got.capacity)]
                want_rows = np.asarray(want.data)[: min(int(want.count), want.capacity)]
                (_assert_float32_close if close else assert_bitwise)(rows, want_rows, where + " rows")
        elif isinstance(want, list):
            assert isinstance(got, list) and len(got) == len(want), where
            for g, w in zip(got, want):
                (_assert_float32_close if close else assert_bitwise)(g, np.asarray(w), where)
        else:
            assert_bitwise(got, np.asarray(want), where)


def _assert_float32_close(got: torch.Tensor, want: Any, msg: str, rtol: float = RTOL, atol: float = ATOL) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.float32 and want.dtype == np.float32, msg
    assert_close(got.numpy().astype(np.float64), want.astype(np.float64), rtol=rtol, atol=atol, msg=msg)


def leaves(result: Any) -> List[np.ndarray]:
    """A result tree's arrays in order (dicts by sorted key)."""
    if isinstance(result, dict):
        return [x for k in sorted(result) for x in leaves(result[k])]
    if isinstance(result, (list, tuple)):
        return [x for v in result for x in leaves(v)]
    if isinstance(result, torch.Tensor):
        return [result.detach().cpu().numpy()]
    return [np.asarray(result)]


def assert_same_result(name: str, got: Any, want: Any, bitwise: bool = None, msg: str = "") -> None:
    bitwise = name in BITWISE_RESULTS if bitwise is None else bitwise
    g, w = leaves(got), leaves(want)
    assert len(g) == len(w), f"{msg}: {len(g)} result arrays against {len(w)}"
    for i, (a, b) in enumerate(zip(g, w)):
        if bitwise:
            assert_bitwise(a, b, f"{msg}: result {i}")
        else:
            rtol, atol = tolerance(name)
            assert_close(a.astype(np.float64), b.astype(np.float64), rtol=rtol, atol=atol, msg=f"{msg}: result {i}")


# --------------------------------------------------------------------------- #
# engine partitions
# --------------------------------------------------------------------------- #
def _reason(reason: str) -> str:
    if reason.startswith(_RUNTIME):
        return _RUNTIME
    return reason.split(_HEAVY)[0]


def partition(metric: Any) -> Dict[str, Tuple[str, str]]:
    view = metric.engine_stats()["partition"]
    return {kind: (view[kind]["path"], _reason(view[kind]["reason"])) for kind in ("update", "compute")}


def same_partition(ref: Any, twin: Any, msg: str = "") -> Dict[str, Tuple[str, str]]:
    """Each kind's path and reason equal the JAX engine's; returns them."""
    want, got = partition(ref), partition(twin)
    assert got == want, f"{msg}: partition {got} != the JAX engine's {want}"
    return got


COUNTERS = ("eager_calls", "cache_misses", "cache_hits", "donated_calls")


def counters(metric: Any) -> Dict[str, Dict[str, int]]:
    stats = metric.engine_stats()
    return {kind: {k: getattr(stats[kind], k) for k in COUNTERS} for kind in ("update", "compute")
            if stats[kind] is not None}


# --------------------------------------------------------------------------- #
# the runs
# --------------------------------------------------------------------------- #
def _engines_off(metric: Any) -> None:
    """The JAX metric (and a composition's operands) with both engines off."""
    for m in [metric] + [getattr(metric, k) for k in ("metric_a", "metric_b") if isinstance(getattr(metric, k, None), M.Metric)]:
        m._compiled_update = m._compiled_compute = False


def run_eager(name: str, buffered: bool = False) -> Tuple[Any, Any, Any, Any]:
    """(a): both twins with the engines off, then compute."""
    ref = reference(name, buffered)
    _engines_off(ref)
    port = twin(name, buffered, compiled_update=False, compiled_compute=False)
    update_both(ref, port, batches(name))
    return ref, port, ref.compute(), port.compute()


def _split(calls: List[Tuple[tuple, dict]], parts: int) -> List[Tuple[tuple, dict]]:
    """Each call as ``parts`` calls of its rows in turn (arrays split on dim 0)."""
    out = []
    for args, kwargs in calls:
        for k in range(parts):
            part = lambda a: np.array_split(a, parts)[k] if isinstance(a, np.ndarray) else a  # noqa: E731
            out.append((tuple(part(a) for a in args), {key: part(v) for key, v in kwargs.items()}))
    return out


# entries whose (b) runs fewer rounds: MS-SSIM's states grow each round, and
# each of the JAX package's eager 5-scale computes compiles every operation
# again at the new batch size (about 6.5 s a round on the CPU). Unbuffered,
# its update and compute reach neither engine (every counter stays 0);
# buffered, its one round is cut into as many calls as the rounds it
# replaces, so the engine sees the same warmup, capture and replays
ENGINE_ROUNDS = {"MultiScaleStructuralSimilarityIndexMeasure": 1}


def engine_calls(name: str, buffered: bool = False, rounds: int = 4) -> Tuple[int, List[Tuple[tuple, dict]]]:
    """The rounds (b) runs and each round's calls. A buffered entry whose
    ``INVENTORY`` capacity holds fewer than ``rounds`` rounds of its rows (the
    image entries' 16) runs as many rounds as fit (or its ``ENGINE_ROUNDS``),
    each call split in two halves per round that fits, so the engine still
    sees a warmup, a capture and replays."""
    calls = batches(name)
    if not buffered:
        return min(rounds, ENGINE_ROUNDS.get(name, rounds)), calls
    capacity = INVENTORY[name].buffered().buffer_capacity
    rows = sum(args[0].shape[0] for args, _ in calls)
    if capacity < rounds * rows:
        fit = max(capacity // rows, 1)
        kept = min(fit, ENGINE_ROUNDS.get(name, fit))
        return kept, _split(calls, 2 * fit // kept)
    return rounds, calls


def run_engines(name: str, buffered: bool = False, rounds: int = 4) -> Dict[str, Any]:
    """(b): the engines at their defaults; each round is one update of the
    entry's calls (:func:`engine_calls`), then one compute."""
    ref, port = reference(name, buffered), twin(name, buffered)
    rounds, calls = engine_calls(name, buffered, rounds)
    results = []
    for _ in range(rounds):
        update_both(ref, port, calls)
        results.append((ref.compute(), port.compute()))
    return {"ref": ref, "twin": port, "results": results, "calls": calls}


# --------------------------------------------------------------------------- #
# the checks the two test modules parametrize
# --------------------------------------------------------------------------- #
# the twins in alphabetical order, cut where the measured time of their tests
# halves (through MultiScaleStructuralSimilarityIndexMeasure, 51 entries)
_ALL = sorted(TWINS)
_CUT = _ALL.index("MultiScaleStructuralSimilarityIndexMeasure") + 1
PARITY_PARTS = (_ALL[:_CUT], _ALL[_CUT:])
WORLD = 4


def check_eager(name: str, buffered: bool) -> None:
    """(a), or (c)'s eager half."""
    ref, port, want, got = run_eager(name, buffered)
    if name in COMPARE_STATES:
        assert_same_states(ref, port, name)
    assert_same_result(name, got, want, msg=name)


def check_engines(name: str, buffered: bool) -> Tuple[Dict[str, Tuple[str, str]], Any]:
    """(b), or (c)'s captured half: the partition, the counters, each
    round's result and states; the engines change no bit of the port's own
    eager run."""
    run = run_engines(name, buffered)
    ref, port = run["ref"], run["twin"]
    part = same_partition(ref, port, name)
    assert counters(port) == counters(ref), name
    for k, (want, got) in enumerate(run["results"]):
        assert_same_result(name, got, want, msg=f"{name} round {k}")
    if name in COMPARE_STATES:
        assert_same_states(ref, port, name)
    eager = twin(name, buffered, compiled_update=False, compiled_compute=False)
    for _ in run["results"]:
        for args, kwargs in run["calls"]:
            eager.update(*to_torch(args), **to_torch(kwargs))
    assert_same_result(name, run["results"][-1][1], eager.compute(), bitwise=True, msg=f"{name} against eager")
    return part, port


def check_buffered_capture(name: str) -> None:
    """(c): the buffered update captured where the JAX update compiles."""
    part, port = check_engines(name, True)
    assert INVENTORY[name].buffered_level in ("update_sync", "full")
    # one captured step per signature: KID's `real` routes each batch through
    # its own (bucketed path), so its two values are two captures
    statics = {tuple(sorted(kwargs.items())) for _, kwargs in batches(name)}
    assert part["update"] == (("fused", "compilable") if len(statics) == 1 else (
        "bucketed", "static update kwargs (real) close over per-value jit variants in the per-metric engine"))
    stats = port.engine_stats()["update"]
    assert stats.cache_misses == len(statics) and stats.cache_hits >= 1


def _holds_array(tree: Any) -> bool:
    if isinstance(tree, np.ndarray):
        return True
    if isinstance(tree, dict):
        return any(_holds_array(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_holds_array(v) for v in tree)
    return False


def _host_inputs(name: str) -> bool:
    """An entry whose calls hold no array anywhere (text corpora, SQuAD's
    dicts): each rank is fed the whole call, and the oracle every rank's copy
    in turn. BERTScore's synced compute is tested in tests/test_torch_bert.py."""
    return name != "BERTScore" and not _holds_array(batches(name))


def _splittable(name: str) -> bool:
    """Every positional argument an array whose rows split evenly; keyword
    arguments arrays too, or Python scalars (FID's and KID's ``real``),
    which every rank gets as they are."""
    if _host_inputs(name):
        return True
    for args, kwargs in batches(name):
        arrays = [a for a in (*args, *kwargs.values()) if isinstance(a, np.ndarray)]
        scalars = [v for v in kwargs.values() if isinstance(v, (bool, int, float))]
        if not arrays or len(arrays) + len(scalars) != len(args) + len(kwargs) or arrays[0].shape[0] % WORLD:
            return False
    return True


def sync_cases(names: List[str]) -> List[Tuple[str, bool]]:
    return [(n, False) for n in names if _splittable(n)] + [(n, True) for n in names if has_buffered(n) and _splittable(n)]


def rank_calls(name: str) -> List[List[Tuple[tuple, dict]]]:
    """Each rank's calls: the rows of every call in WORLD consecutive parts."""
    per_rank: List[List[Tuple[tuple, dict]]] = [[] for _ in range(WORLD)]
    for args, kwargs in batches(name):
        split = lambda a: np.split(a, WORLD) if isinstance(a, np.ndarray) else [a] * WORLD  # noqa: E731
        parts = [split(a) for a in args]
        kparts = {k: split(v) for k, v in kwargs.items()}
        for r in range(WORLD):
            per_rank[r].append((tuple(p[r] for p in parts), {k: v[r] for k, v in kparts.items()}))
    return per_rank


def rank_seed(name: str, rank: int) -> Optional[int]:
    """The seed of rank ``rank``'s generator for a ``SEEDED`` entry, else None."""
    return SEEDED[name] + rank if name in SEEDED else None


def oracle(name: str, buffered: bool, per_rank: List[List[Tuple[tuple, dict]]], **kwargs: Any) -> Any:
    metric = make_twin(name, buffered, **kwargs)
    for rank, calls in enumerate(per_rank):
        # each rank's resampling comes from its own generator
        seed_generator(name, metric, rank_seed(name, rank))
        for args, kw in calls:
            metric.update(*to_torch(args), **to_torch(kw))
    return metric.compute()


def check_synced(world: Any, name: str, buffered: bool) -> None:
    """(d): the synced compute on every rank against the rank-major oracle."""
    from tests.helpers import torch_dist as td

    per_rank = rank_calls(name)
    # a compute that draws host indices draws them from the same seed on every rank
    kwargs = {"seed": SEEDED_COMPUTE[name]} if name in SEEDED_COMPUTE else None
    results = world.run(td.twin_synced_compute,
                        [(name, buffered, calls, kwargs, rank_seed(name, r)) for r, calls in enumerate(per_rank)])
    want = oracle(name, buffered, per_rank, **(kwargs or {}))
    # a float32 sum state adds the ranks' partial sums in the collective's
    # order, not the oracle's batch order: equal within the bound
    bitwise = name not in FLOAT_SUM_STATES
    for rank, got in enumerate(results):
        assert_same_result(name, got, want, bitwise=bitwise, msg=f"{name} rank {rank}")

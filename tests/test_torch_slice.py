"""The port's first slice end to end against the JAX package, at a small size.

The slice is the main path of ``__graft_entry__``: a MetricCollection of
Accuracy (micro) and F1/Precision/Recall (macro), plus the
BinnedAveragePrecision of its multichip twin, here with C=10 classes, T=21
thresholds and 3 batches. Both packages take the same numpy batches; the
binned metric takes the same float32 probabilities, computed in numpy, since
the two packages' softmaxes differ in the last ulp. Count states must match
bit for bit and results within rtol=1e-6, atol=1e-7.
"""
import ast
import doctest
import importlib
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt_jax
import metrics_tpu_torch as mt_torch
from __graft_entry__ import _make_collection
from metrics_tpu_torch.convert import state_from_numpy, state_to_numpy
from tests.helpers.torch_port import assert_bitwise, assert_close, strict_float32

strict_float32()

C, T, N_BATCH, BATCH = 10, 21, 3, 64
REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_DIR = REPO / "metrics_tpu_torch"


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(N_BATCH):
        logits = rng.normal(size=(BATCH, C)).astype(np.float32)
        probs = (np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)).astype(np.float32)
        yield logits, probs, rng.integers(0, C, size=BATCH).astype(np.int32)


def _torch_collection():
    return mt_torch.MetricCollection(
        {
            "acc": mt_torch.Accuracy(num_classes=C, average="micro", device="cpu"),
            "f1": mt_torch.F1Score(num_classes=C, average="macro", device="cpu"),
            "precision": mt_torch.Precision(num_classes=C, average="macro", device="cpu"),
            "recall": mt_torch.Recall(num_classes=C, average="macro", device="cpu"),
        }
    )


def _assert_states_equal(torch_states, jax_states):
    assert set(torch_states) == set(jax_states)
    for key, value in jax_states.items():
        if isinstance(value, dict):
            _assert_states_equal(torch_states[key], value)
        else:
            assert_bitwise(torch_states[key], value, msg=key)


def _assert_results_close(torch_results, jax_results):
    assert set(torch_results) == set(jax_results)
    for key in jax_results:
        assert_close(torch_results[key], jax_results[key], msg=key)


def test_slice_states_and_results_match():
    jax_coll, torch_coll = _make_collection(C), _torch_collection()
    jax_binned = mt_jax.BinnedAveragePrecision(num_classes=C, thresholds=T)
    torch_binned = mt_torch.BinnedAveragePrecision(num_classes=C, thresholds=T, device="cpu")
    jax_states, jax_binned_state = jax_coll.init_state(), jax_binned.init_state()
    for logits, probs, target in _batches():
        jax_states = jax_coll.update_state(jax_states, jnp.asarray(logits), jnp.asarray(target))
        jax_binned_state = jax_binned.update_state(jax_binned_state, jnp.asarray(probs), jnp.asarray(target))
        torch_coll.update(torch.from_numpy(logits), torch.from_numpy(target))
        torch_binned.update(torch.from_numpy(probs), torch.from_numpy(target))

    _assert_states_equal(state_to_numpy(torch_coll), {k: {s: np.asarray(v) for s, v in st.items()} for k, st in jax_states.items()})
    _assert_states_equal(state_to_numpy(torch_binned), {s: np.asarray(v) for s, v in jax_binned_state.items()})
    _assert_results_close(torch_coll.compute(), jax_coll.compute_state(jax_states))
    got_ap = torch_binned.compute()
    want_ap = jax_binned.compute_state(jax_binned_state)
    assert len(got_ap) == len(want_ap) == C
    assert_close(torch.stack(got_ap), np.stack([np.asarray(a) for a in want_ap]))


def test_compute_groups_match():
    assert _torch_collection().compute_groups == _make_collection(C).compute_groups
    assert _torch_collection().compute_groups == {0: ["acc"], 1: ["f1", "precision", "recall"]}


def test_pure_protocol_matches_the_facade():
    torch_coll = _torch_collection()
    states = torch_coll.init_state()
    for logits, _, target in _batches(1):
        states = torch_coll.update_state(states, torch.from_numpy(logits), torch.from_numpy(target))
        torch_coll.update(torch.from_numpy(logits), torch.from_numpy(target))
    _assert_states_equal(
        {k: {s: v.numpy() for s, v in st.items()} for k, st in states.items()}, state_to_numpy(torch_coll)
    )
    assert {k: float(v) for k, v in torch_coll.compute_state(states).items()} == {
        k: float(v) for k, v in torch_coll.compute().items()
    }


def test_state_carries_from_jax_into_the_port():
    """A stream starts in metrics_tpu and continues in metrics_tpu_torch."""
    (l1, p1, t1), (l2, p2, t2), _ = _batches(2)
    jax_coll = _make_collection(C)
    jax_binned = mt_jax.BinnedAveragePrecision(num_classes=C, thresholds=T)
    jax_states = jax_coll.update_state(jax_coll.init_state(), jnp.asarray(l1), jnp.asarray(t1))
    jax_binned_state = jax_binned.update_state(jax_binned.init_state(), jnp.asarray(p1), jnp.asarray(t1))

    torch_coll = _torch_collection()
    torch_binned = mt_torch.BinnedAveragePrecision(num_classes=C, thresholds=T, device="cpu")
    state_from_numpy(torch_coll, {k: {s: np.asarray(v) for s, v in st.items()} for k, st in jax_states.items()})
    state_from_numpy(torch_binned, {s: np.asarray(v) for s, v in jax_binned_state.items()}, device="cpu")

    jax_states = jax_coll.update_state(jax_states, jnp.asarray(l2), jnp.asarray(t2))
    jax_binned_state = jax_binned.update_state(jax_binned_state, jnp.asarray(p2), jnp.asarray(t2))
    torch_coll.update(torch.from_numpy(l2), torch.from_numpy(t2))
    torch_binned.update(torch.from_numpy(p2), torch.from_numpy(t2))

    _assert_states_equal(state_to_numpy(torch_coll), {k: {s: np.asarray(v) for s, v in st.items()} for k, st in jax_states.items()})
    _assert_results_close(torch_coll.compute(), jax_coll.compute_state(jax_states))
    assert_close(
        torch.stack(torch_binned.compute()),
        np.stack([np.asarray(a) for a in jax_binned.compute_state(jax_binned_state)]),
    )


def test_state_from_numpy_checks_dtype_shape_and_device():
    metric = mt_torch.Precision(num_classes=C, average="macro", device="cpu")
    good = {s: np.zeros(C, np.int32) for s in ("tp", "fp", "tn", "fn")}
    state_from_numpy(metric, good)
    with pytest.raises(ValueError, match="int32"):
        state_from_numpy(metric, {**good, "tp": np.zeros(C, np.int64)})
    with pytest.raises(ValueError, match=r"\(10,\)"):
        state_from_numpy(metric, {**good, "fp": np.zeros(C + 1, np.int32)})
    with pytest.raises(ValueError, match="states"):
        state_from_numpy(metric, {"tp": good["tp"]})
    with pytest.raises(ValueError, match="keeps its state on cpu"):
        state_from_numpy(metric, good, device="meta")


def test_forward_batch_values_match():
    jax_metric = mt_jax.F1Score(num_classes=C, average="macro")
    torch_metric = mt_torch.F1Score(num_classes=C, average="macro", device="cpu")
    for logits, _, target in _batches(3):
        assert_close(torch_metric(torch.from_numpy(logits), torch.from_numpy(target)), jax_metric(jnp.asarray(logits), jnp.asarray(target)))
    assert_close(torch_metric.compute(), jax_metric.compute())


def test_compositional_metric_matches():
    jax_acc, jax_f1 = mt_jax.Accuracy(), mt_jax.F1Score(num_classes=C, average="macro")
    torch_acc, torch_f1 = mt_torch.Accuracy(device="cpu"), mt_torch.F1Score(num_classes=C, average="macro", device="cpu")
    jax_combined, torch_combined = (jax_acc + jax_f1) / 2, (torch_acc + torch_f1) / 2
    for logits, _, target in _batches(5):
        jax_combined.update(jnp.asarray(logits), jnp.asarray(target))
        torch_combined.update(torch.from_numpy(logits), torch.from_numpy(target))
    assert_close(torch_combined.compute(), jax_combined.compute())


def test_state_dict_round_trip():
    coll = _torch_collection()
    for logits, _, target in _batches(6):
        coll.update(torch.from_numpy(logits), torch.from_numpy(target))
    coll.persistent(True)
    saved = coll.state_dict()
    assert sorted(saved)[:4] == ["acc.fn", "acc.fp", "acc.tn", "acc.tp"]
    restored = _torch_collection()
    restored.load_state_dict(saved)
    _assert_states_equal(state_to_numpy(restored), state_to_numpy(coll))
    # Accuracy's input mode is set by an update, not stored, as in the JAX package
    logits, _, target = next(_batches(7))
    for c in (coll, restored):
        c.update(torch.from_numpy(logits), torch.from_numpy(target))
    assert {k: float(v) for k, v in restored.compute().items()} == {k: float(v) for k, v in coll.compute().items()}


@pytest.mark.parametrize(
    "make",
    [
        lambda: mt_torch.BinnedPrecisionRecallCurve(num_classes=C, thresholds=T, device="cpu"),
        lambda: mt_torch.BinnedAveragePrecision(num_classes=C, thresholds=T, device="cpu"),
        lambda: mt_torch.BinnedRecallAtFixedPrecision(num_classes=C, min_precision=0.5, thresholds=T, device="cpu"),
    ],
    ids=["curve", "average_precision", "recall_at_precision"],
)
def test_to_moves_state_and_defaults(make, monkeypatch):
    metric = make()
    moved = []
    hook = type(metric)._move_attributes
    monkeypatch.setattr(type(metric), "_move_attributes", lambda self, device: (moved.append(device), hook(self, device)))
    assert metric.to("meta") is metric and moved == [torch.device("meta")]
    assert metric.device == torch.device("meta")
    assert all(v.device.type == "meta" for v in (*metric.get_state().values(), *metric._defaults.values()))
    assert all(t.device.type == "meta" for t in (metric.thresholds, *metric._grid))


def test_to_moves_a_self_loaded_bert_model_and_leaves_the_users(monkeypatch):
    from metrics_tpu_torch.text import bert as bert_module

    fake = type(sys)("transformers")
    fake.AutoTokenizer = type("AutoTokenizer", (), {"from_pretrained": staticmethod(lambda name: object())})
    fake.AutoModel = type("AutoModel", (), {"from_pretrained": staticmethod(lambda name: torch.nn.Linear(2, 2))})
    monkeypatch.setitem(sys.modules, "transformers", fake)
    monkeypatch.setattr(bert_module, "_TRANSFORMERS_AVAILABLE", True)
    loaded = mt_torch.BERTScore(model_name_or_path="tiny", device="cpu").to("meta")
    assert all(p.device.type == "meta" for p in loaded.model.parameters())
    users = torch.nn.Linear(2, 2)
    mt_torch.BERTScore(model=users, user_tokenizer=object(), device="cpu").to("meta")
    assert all(p.device.type == "cpu" for p in users.parameters())


def test_metrics_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
        lambda: mt_torch.Accuracy(),
        lambda: mt_torch.F1Score(num_classes=C, average="macro"),
        lambda: mt_torch.BinnedAveragePrecision(num_classes=C),
        lambda: mt_torch.MeanAveragePrecision(),
        lambda: mt_torch.BERTScore(model=object()),
        lambda: mt_torch.Accuracy(device="cuda"),
        lambda: mt_torch.ConfusionMatrix(num_classes=C),
        lambda: mt_torch.JaccardIndex(num_classes=C),
        lambda: mt_torch.MatthewsCorrCoef(num_classes=C),
        lambda: mt_torch.CohenKappa(num_classes=C),
        lambda: mt_torch.Specificity(num_classes=C),
        lambda: mt_torch.Dice(num_classes=C),
        lambda: mt_torch.HammingDistance(),
        lambda: mt_torch.HingeLoss(),
        lambda: mt_torch.KLDivergence(),
        lambda: mt_torch.CoverageError(),
        lambda: mt_torch.LabelRankingAveragePrecision(),
        lambda: mt_torch.LabelRankingLoss(),
        lambda: mt_torch.SumMetric(),
        lambda: mt_torch.MeanMetric(),
        lambda: mt_torch.MaxMetric(),
        lambda: mt_torch.MinMetric(),
        lambda: mt_torch.CatMetric(buffer_capacity=8),
        lambda: mt_torch.MeanSquaredError(),
        lambda: mt_torch.PearsonCorrCoef(),
        lambda: mt_torch.SpearmanCorrCoef(buffer_capacity=8),
        lambda: mt_torch.TweedieDevianceScore(power=1.5),
        lambda: mt_torch.RetrievalMAP(),
        lambda: mt_torch.RetrievalNormalizedDCG(max_queries=4, max_docs_per_query=4, buffer_capacity=8),
        lambda: mt_torch.RetrievalRecallAtFixedPrecision(min_precision=0.5),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_reset_restores_defaults_and_keeps_them_intact():
    coll = _torch_collection()
    for logits, _, target in _batches(4):
        coll.update(torch.from_numpy(logits), torch.from_numpy(target))
    coll.reset()
    for _, metric in coll.items():
        for name, value in metric.get_state().items():
            assert not value.any(), name
            assert value is not metric._defaults[name]


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import metrics_tpu_torch, metrics_tpu_torch.convert, metrics_tpu_torch.ops, metrics_tpu_torch.detection\n"
        "import metrics_tpu_torch.ops.kernels.iou_matching, metrics_tpu_torch.ops.kernels.cosine_matching\n"
        "import metrics_tpu_torch.text, metrics_tpu_torch.ops.text.bert, metrics_tpu_torch.utils.imports\n"
        "import metrics_tpu_torch.parallel, metrics_tpu_torch.entry, metrics_tpu_torch.core.engine\n"
        "import metrics_tpu_torch.parallel.sync, metrics_tpu_torch.parallel.mesh, metrics_tpu_torch.core.collections\n"
        "import metrics_tpu_torch.ops.classification.auroc, metrics_tpu_torch.ops.classification.calibration_error\n"
        "import metrics_tpu_torch.ops.classification.average_precision, metrics_tpu_torch.aggregation\n"
        "import metrics_tpu_torch.ops.classification.ranking, metrics_tpu_torch.ops.classification.kl_divergence\n"
        "import metrics_tpu_torch.regression, metrics_tpu_torch.ops.regression, metrics_tpu_torch.ops.pairwise\n"
        "import metrics_tpu_torch.retrieval, metrics_tpu_torch.ops.retrieval, metrics_tpu_torch.ops.retrieval.segmented\n"
        "import metrics_tpu_torch.core.buffers, metrics_tpu_torch.core.metric, metrics_tpu_torch.ops.classification._ratio\n"
        "import metrics_tpu_torch.ops.classification.matthews_corrcoef, metrics_tpu_torch.classification.confusion_matrix\n"
        "from metrics_tpu_torch.parallel import psum_result, gather_result, shard_spec, grid_sharded  # sharded state\n"
        "import metrics_tpu_torch.observability, metrics_tpu_torch.observability.__main__, metrics_tpu_torch.resilience\n"
        "import metrics_tpu_torch.utils.httpd, metrics_tpu_torch.utils.profiling, metrics_tpu_torch.observability.regress\n"
        "import metrics_tpu_torch.serve, metrics_tpu_torch.cluster, metrics_tpu_torch.cluster.__main__\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'metrics_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_name_neither_jax_nor_the_jax_package():
    for path in sorted(PORT_DIR.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "metrics_tpu"), f"{path}: imports {name}"


PORT_MODULES_WITH_EXAMPLES = [
    "metrics_tpu_torch.core.metric",
    "metrics_tpu_torch.core.collections",
    "metrics_tpu_torch.classification.stat_scores",
    "metrics_tpu_torch.classification.accuracy",
    "metrics_tpu_torch.classification.precision_recall",
    "metrics_tpu_torch.classification.f_beta",
    "metrics_tpu_torch.classification.binned_precision_recall",
    "metrics_tpu_torch.ops.classification.stat_scores",
    "metrics_tpu_torch.ops.classification.accuracy",
    "metrics_tpu_torch.ops.classification.precision_recall",
    "metrics_tpu_torch.ops.classification.f_beta",
    "metrics_tpu_torch.core.buffers",
    "metrics_tpu_torch.ops.detection.boxes",
    "metrics_tpu_torch.detection.mean_ap",
    "metrics_tpu_torch.ops.text.bert",
    "metrics_tpu_torch.text.bert",
    "metrics_tpu_torch.parallel.mesh",
    "metrics_tpu_torch.entry",
    "metrics_tpu_torch.ops.classification.precision_recall_curve",
    "metrics_tpu_torch.ops.classification.roc",
    "metrics_tpu_torch.ops.classification.auc",
    "metrics_tpu_torch.ops.classification.auroc",
    "metrics_tpu_torch.ops.classification.average_precision",
    "metrics_tpu_torch.ops.classification.calibration_error",
    "metrics_tpu_torch.classification.precision_recall_curve",
    "metrics_tpu_torch.classification.roc",
    "metrics_tpu_torch.classification.auc",
    "metrics_tpu_torch.classification.auroc",
    "metrics_tpu_torch.classification.avg_precision",
    "metrics_tpu_torch.classification.calibration_error",
    "metrics_tpu_torch.aggregation",
    "metrics_tpu_torch.classification.confusion_matrix",
    "metrics_tpu_torch.classification.jaccard",
    "metrics_tpu_torch.classification.matthews_corrcoef",
    "metrics_tpu_torch.classification.cohen_kappa",
    "metrics_tpu_torch.classification.specificity",
    "metrics_tpu_torch.classification.dice",
    "metrics_tpu_torch.classification.hamming",
    "metrics_tpu_torch.classification.hinge",
    "metrics_tpu_torch.classification.kl_divergence",
    "metrics_tpu_torch.classification.ranking",
    "metrics_tpu_torch.ops.classification.confusion_matrix",
    "metrics_tpu_torch.ops.classification.jaccard",
    "metrics_tpu_torch.ops.classification.matthews_corrcoef",
    "metrics_tpu_torch.ops.classification.cohen_kappa",
    "metrics_tpu_torch.ops.classification.specificity",
    "metrics_tpu_torch.ops.classification.dice",
    "metrics_tpu_torch.ops.classification.hamming",
    "metrics_tpu_torch.ops.classification.hinge",
    "metrics_tpu_torch.ops.classification.kl_divergence",
    "metrics_tpu_torch.ops.classification.ranking",
    "metrics_tpu_torch.regression.basic",
    "metrics_tpu_torch.regression.other",
    "metrics_tpu_torch.regression.moments",
    "metrics_tpu_torch.ops.regression.basic",
    "metrics_tpu_torch.ops.regression.other",
    "metrics_tpu_torch.ops.regression.moments",
    "metrics_tpu_torch.ops.pairwise",
    "metrics_tpu_torch.ops.retrieval",
    "metrics_tpu_torch.retrieval.metrics",
    "metrics_tpu_torch.retrieval.precision_recall_curve",
    "metrics_tpu_torch.wrappers.bootstrapping",
    "metrics_tpu_torch.wrappers.classwise",
    "metrics_tpu_torch.wrappers.minmax",
    "metrics_tpu_torch.wrappers.multioutput",
    "metrics_tpu_torch.wrappers.tracker",
    "metrics_tpu_torch.ops.text.error_rates",
    "metrics_tpu_torch.ops.text.bleu",
    "metrics_tpu_torch.ops.text.sacre_bleu",
    "metrics_tpu_torch.ops.text.chrf",
    "metrics_tpu_torch.ops.text.ter",
    "metrics_tpu_torch.ops.text.eed",
    "metrics_tpu_torch.ops.text.rouge",
    "metrics_tpu_torch.ops.text.squad",
    "metrics_tpu_torch.text.error_rates",
    "metrics_tpu_torch.text.bleu",
    "metrics_tpu_torch.text.chrf",
    "metrics_tpu_torch.text.ter",
    "metrics_tpu_torch.text.eed",
    "metrics_tpu_torch.text.rouge",
    "metrics_tpu_torch.text.squad",
    "metrics_tpu_torch.ops.detection.rle",
    "metrics_tpu_torch.ops.detection.matching",
]


@pytest.mark.parametrize("module", PORT_MODULES_WITH_EXAMPLES)
def test_port_docstring_examples(module):
    result = doctest.testmod(importlib.import_module(module), optionflags=doctest.ELLIPSIS)
    assert result.attempted > 0 and result.failed == 0, result

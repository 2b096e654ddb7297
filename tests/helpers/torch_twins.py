"""The port twin of each ``INVENTORY`` entry that has one, built with the
entry's own constructor arguments (``tests/helpers/inventory.py``).

This module imports torch, numpy and ``metrics_tpu_torch`` only (never JAX):
the gloo ranks of ``tests/helpers/torch_dist.py`` import it to build the same
twins. ``tests/helpers/torch_parity.py`` holds the harness that runs them
against the JAX package.

``TWINS[name].make(**kw)`` builds the twin of ``INVENTORY[name].make()`` and
``TWINS[name].buffered(**kw)`` that of ``INVENTORY[name].buffered()``; ``kw``
adds the port's own keywords (the engine switches), and ``device="cpu"`` is
always passed. mAP's twin is its ``INVENTORY`` maker, the host-list route
(``device_state=False``); a caller may pass ``device_state=True`` for the
buffered device route. BERTScore's twin runs a torch copy of the
``INVENTORY``'s sine forward. BootStrapper's maker draws from an
unseeded generator, so the harness seeds both sides alike (``SEEDED`` in
``tests/helpers/torch_parity.py``). FID, KID and IS take a torch copy of the
INVENTORY's stub extractor with the same ``w`` (replayed from its seed),
LPIPS a torch copy of its stub distance.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

import metrics_tpu_torch as mt

C = 4  # the INVENTORY's class count


class Twin(NamedTuple):
    make: Callable[..., Any]
    buffered: Optional[Callable[..., Any]] = None


class WhitespaceTokenizer:
    """The port side of the INVENTORY's BERTScore tokenizer: ids by first
    appearance within one call, 8 wide, numpy out."""

    def __call__(self, sentences, max_length=64, **kwargs):
        vocab: Dict[str, int] = {}
        ids = np.zeros((len(sentences), 8), dtype=np.int32)
        mask = np.zeros((len(sentences), 8), dtype=np.int32)
        for i, s in enumerate(sentences):
            for j, tok in enumerate(s.split()[:8]):
                ids[i, j] = vocab.setdefault(tok, len(vocab) + 1)
                mask[i, j] = 1
        return {"input_ids": ids, "attention_mask": mask}


def sine_forward(model: Any, batch: Dict[str, Any]) -> torch.Tensor:
    """The INVENTORY's BERTScore forward: token id i embeds as
    ``sin(arange(8) * (1 + i))``."""
    ids = torch.as_tensor(np.asarray(batch["input_ids"].cpu() if isinstance(batch["input_ids"], torch.Tensor)
                                     else batch["input_ids"]))
    rows = [torch.sin(torch.arange(8, dtype=torch.float32) * (1.0 + float(i))) for i in ids.reshape(-1).tolist()]
    return torch.stack(rows).reshape(*ids.shape, 8)


def _inventory_stub_w() -> np.ndarray:
    """The ``w`` of the INVENTORY's ``_STUB_FEATURES``: its module-level
    generator (seed 1234) replayed through every draw that precedes the stub
    (``tests/helpers/inventory.py:40-84``), without importing JAX."""
    rng = np.random.default_rng(1234)
    n, c = 24, C
    rng.dirichlet(np.ones(c), size=n)
    rng.integers(0, c, n)
    rng.random(n)
    rng.integers(0, 2, n)
    rng.random((n, c))
    rng.integers(0, 2, (n, c))
    rng.normal(size=(n, c))
    for shape in (n, n, (n, 2), (n, 2), (8, 3, 16, 16), (8, 3, 16, 16), (8, 1, 192, 192), (8, 1, 192, 192)):
        rng.random(shape)
    for shape in ((8, 2000), (8, 2000), (8, 2, 1200), (8, 2, 1200), (8, 8000), (8, 8000)):
        rng.normal(size=shape)
    rng.random(n)
    rng.integers(0, 2, n)
    rng.integers(0, 4, n)
    in_dim = 3 * 16 * 16
    return (rng.normal(size=(in_dim, 6)).astype(np.float32) / np.sqrt(in_dim)).astype(np.float32)


class StubFeatures:
    """The port side of the INVENTORY's ``_StubFeatures``: the same
    ``imgs -> (N, 6)`` projection with the same ``w``."""

    num_features = 6

    def __init__(self) -> None:
        self.w = torch.from_numpy(_inventory_stub_w())

    def __call__(self, imgs: torch.Tensor) -> torch.Tensor:
        return imgs.reshape(imgs.shape[0], -1) @ self.w.to(imgs.device)


def stub_lpips(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The INVENTORY's ``_StubLPIPSNet``: the per-pair mean squared difference."""
    return torch.mean((a - b) ** 2, dim=(1, 2, 3))


STUB_FEATURES = StubFeatures()


def _cpu(factory: Callable[..., Any]) -> Callable[..., Any]:
    return lambda **kw: factory(device="cpu", **kw)


def _default(name: str, **args: Any) -> Callable[..., Any]:
    """The port's class ``name`` built with ``args``, on the CPU."""
    cls = getattr(mt, name)
    return _cpu(lambda **kw: cls(**args, **kw))


TWINS: Dict[str, Twin] = {
    "Accuracy": Twin(_cpu(lambda **kw: mt.Accuracy(num_classes=C, **kw))),
    "AUC": Twin(
        _cpu(lambda **kw: mt.AUC(reorder=True, **kw)),
        _cpu(lambda **kw: mt.AUC(reorder=True, buffer_capacity=256, **kw)),
    ),
    "AUROC": Twin(
        _cpu(lambda **kw: mt.AUROC(num_classes=C, **kw)),
        _cpu(lambda **kw: mt.AUROC(num_classes=C, buffer_capacity=256, **kw)),
    ),
    "AveragePrecision": Twin(
        _cpu(lambda **kw: mt.AveragePrecision(num_classes=C, **kw)),
        _cpu(lambda **kw: mt.AveragePrecision(num_classes=C, buffer_capacity=256, **kw)),
    ),
    "BinnedAveragePrecision": Twin(_cpu(lambda **kw: mt.BinnedAveragePrecision(num_classes=C, thresholds=21, **kw))),
    "BinnedPrecisionRecallCurve": Twin(
        _cpu(lambda **kw: mt.BinnedPrecisionRecallCurve(num_classes=C, thresholds=21, **kw))
    ),
    "BinnedRecallAtFixedPrecision": Twin(
        _cpu(lambda **kw: mt.BinnedRecallAtFixedPrecision(num_classes=C, min_precision=0.5, thresholds=21, **kw))
    ),
    "CalibrationError": Twin(
        _cpu(lambda **kw: mt.CalibrationError(n_bins=10, **kw)),
        _cpu(lambda **kw: mt.CalibrationError(n_bins=10, buffer_capacity=256, **kw)),
    ),
    "F1Score": Twin(_cpu(lambda **kw: mt.F1Score(num_classes=C, **kw))),
    "FBetaScore": Twin(_cpu(lambda **kw: mt.FBetaScore(num_classes=C, beta=2.0, **kw))),
    "Precision": Twin(_cpu(lambda **kw: mt.Precision(num_classes=C, **kw))),
    "PrecisionRecallCurve": Twin(
        _cpu(lambda **kw: mt.PrecisionRecallCurve(num_classes=C, **kw)),
        _cpu(lambda **kw: mt.PrecisionRecallCurve(num_classes=C, buffer_capacity=256, **kw)),
    ),
    "ROC": Twin(
        _cpu(lambda **kw: mt.ROC(num_classes=C, **kw)),
        _cpu(lambda **kw: mt.ROC(num_classes=C, buffer_capacity=256, **kw)),
    ),
    "Recall": Twin(_cpu(lambda **kw: mt.Recall(num_classes=C, **kw))),
    "StatScores": Twin(_cpu(lambda **kw: mt.StatScores(num_classes=C, **kw))),
    "CohenKappa": Twin(_cpu(lambda **kw: mt.CohenKappa(num_classes=C, **kw))),
    "ConfusionMatrix": Twin(_cpu(lambda **kw: mt.ConfusionMatrix(num_classes=C, **kw))),
    "Dice": Twin(_cpu(lambda **kw: mt.Dice(num_classes=C, multiclass=True, **kw))),
    "HammingDistance": Twin(_cpu(lambda **kw: mt.HammingDistance(**kw))),
    "HingeLoss": Twin(_cpu(lambda **kw: mt.HingeLoss(multiclass_mode="crammer-singer", **kw))),
    "JaccardIndex": Twin(_cpu(lambda **kw: mt.JaccardIndex(num_classes=C, **kw))),
    "KLDivergence": Twin(_cpu(lambda **kw: mt.KLDivergence(**kw))),
    "MatthewsCorrCoef": Twin(_cpu(lambda **kw: mt.MatthewsCorrCoef(num_classes=C, **kw))),
    "Specificity": Twin(_cpu(lambda **kw: mt.Specificity(num_classes=C, **kw))),
    "CoverageError": Twin(_cpu(lambda **kw: mt.CoverageError(**kw))),
    "LabelRankingAveragePrecision": Twin(_cpu(lambda **kw: mt.LabelRankingAveragePrecision(**kw))),
    "LabelRankingLoss": Twin(_cpu(lambda **kw: mt.LabelRankingLoss(**kw))),
    "MeanMetric": Twin(_cpu(lambda **kw: mt.MeanMetric(**kw))),
    "SumMetric": Twin(_cpu(lambda **kw: mt.SumMetric(**kw))),
    "MaxMetric": Twin(_cpu(lambda **kw: mt.MaxMetric(**kw))),
    "MinMetric": Twin(_cpu(lambda **kw: mt.MinMetric(**kw))),
    "CatMetric": Twin(
        _cpu(lambda **kw: mt.CatMetric(**kw)),
        _cpu(lambda **kw: mt.CatMetric(buffer_capacity=256, **kw)),
    ),
    # the sketch aggregators
    "Quantile": Twin(_cpu(lambda **kw: mt.Quantile(q=0.5, **kw))),
    "Median": Twin(_default("Median")),
    "DistinctCount": Twin(_default("DistinctCount")),
    "HeavyHitters": Twin(_cpu(lambda **kw: mt.HeavyHitters(threshold=0.05, max_hitters=4, **kw))),
    "MeanAveragePrecision": Twin(_cpu(lambda **kw: mt.MeanAveragePrecision(**{"device_state": False, **kw}))),
    "BERTScore": Twin(_cpu(lambda **kw: mt.BERTScore(
        model=object(), user_forward_fn=sine_forward, user_tokenizer=WhitespaceTokenizer(), **kw
    ))),
    "CompositionalMetric": Twin(_cpu(lambda **kw: mt.MeanSquaredError(**kw) + mt.MeanAbsoluteError(**kw))),
    # regression
    **{name: Twin(_default(name)) for name in (
        "ExplainedVariance", "MeanAbsoluteError", "MeanAbsolutePercentageError", "MeanSquaredError",
        "MeanSquaredLogError", "PearsonCorrCoef", "R2Score", "SymmetricMeanAbsolutePercentageError",
        "WeightedMeanAbsolutePercentageError",
    )},
    "TweedieDevianceScore": Twin(_default("TweedieDevianceScore", power=1.5)),
    **{name: Twin(_default(name), _default(name, buffer_capacity=256)) for name in (
        "CosineSimilarity", "SpearmanCorrCoef",
        # retrieval
        "RetrievalMAP", "RetrievalMRR", "RetrievalPrecision", "RetrievalRecall", "RetrievalFallOut",
        "RetrievalHitRate", "RetrievalNormalizedDCG", "RetrievalRPrecision",
    )},
    # wrappers: the base metric is built on the CPU too; the engine switches go to the wrapper
    "BootStrapper": Twin(_cpu(lambda **kw: mt.BootStrapper(mt.MeanSquaredError(device="cpu"), num_bootstraps=4, **kw))),
    "ClasswiseWrapper": Twin(_cpu(lambda **kw: mt.ClasswiseWrapper(
        mt.Accuracy(num_classes=C, average="none", device="cpu"), **kw
    ))),
    "MinMaxMetric": Twin(_cpu(lambda **kw: mt.MinMaxMetric(mt.MeanSquaredError(device="cpu"), **kw))),
    "MultioutputWrapper": Twin(_cpu(lambda **kw: mt.MultioutputWrapper(
        mt.MeanSquaredError(device="cpu"), num_outputs=2, **kw
    ))),
    # text
    **{name: Twin(_default(name)) for name in (
        "BLEUScore", "SacreBLEUScore", "CHRFScore", "TranslationEditRate", "ExtendedEditDistance", "CharErrorRate",
        "WordErrorRate", "MatchErrorRate", "WordInfoLost", "WordInfoPreserved", "ROUGEScore", "SQuAD",
    )},
    # image: the quality metrics at the INVENTORY's arguments; FID, KID, IS
    # and LPIPS over torch copies of its stubs
    "PeakSignalNoiseRatio": Twin(_default("PeakSignalNoiseRatio", data_range=1.0)),
    **{name: Twin(_default(name), _default(name, buffer_capacity=64)) for name in (
        "ErrorRelativeGlobalDimensionlessSynthesis", "SpectralAngleMapper", "SpectralDistortionIndex",
    )},
    "UniversalImageQualityIndex": Twin(
        _default("UniversalImageQualityIndex"), _default("UniversalImageQualityIndex", buffer_capacity=16)
    ),
    **{name: Twin(_default(name, data_range=1.0), _default(name, data_range=1.0, buffer_capacity=16)) for name in (
        "StructuralSimilarityIndexMeasure", "MultiScaleStructuralSimilarityIndexMeasure",
    )},
    "FrechetInceptionDistance": Twin(_default("FrechetInceptionDistance", feature=STUB_FEATURES, feature_size=6)),
    "InceptionScore": Twin(
        _default("InceptionScore", feature=STUB_FEATURES),
        _default("InceptionScore", feature=STUB_FEATURES, buffer_capacity=64),
    ),
    "KernelInceptionDistance": Twin(
        _default("KernelInceptionDistance", feature=STUB_FEATURES, subset_size=8, subsets=2),
        _default("KernelInceptionDistance", feature=STUB_FEATURES, subset_size=8, subsets=2, buffer_capacity=64),
    ),
    "LearnedPerceptualImagePatchSimilarity": Twin(_default("LearnedPerceptualImagePatchSimilarity", net=stub_lpips)),
    # audio: the INVENTORY's arguments; PESQ through the native model
    **{name: Twin(_default(name)) for name in (
        "SignalNoiseRatio", "ScaleInvariantSignalNoiseRatio", "ScaleInvariantSignalDistortionRatio",
    )},
    "SignalDistortionRatio": Twin(_default("SignalDistortionRatio", filter_length=64)),
    "PermutationInvariantTraining": Twin(_cpu(lambda **kw: mt.PermutationInvariantTraining(
        mt.ops.scale_invariant_signal_noise_ratio, eval_func="max", **kw
    ))),
    "ShortTimeObjectiveIntelligibility": Twin(_default("ShortTimeObjectiveIntelligibility", fs=10000)),
    "PerceptualEvaluationSpeechQuality": Twin(
        _default("PerceptualEvaluationSpeechQuality", fs=8000, mode="nb", implementation="native")
    ),
    "RetrievalPrecisionRecallCurve": Twin(
        _default("RetrievalPrecisionRecallCurve", max_k=4),
        _default("RetrievalPrecisionRecallCurve", max_k=4, buffer_capacity=256),
    ),
    "RetrievalRecallAtFixedPrecision": Twin(
        _default("RetrievalRecallAtFixedPrecision", min_precision=0.3, max_k=4),
        _default("RetrievalRecallAtFixedPrecision", min_precision=0.3, max_k=4, buffer_capacity=256),
    ),
}


def make_twin(name: str, buffered: bool = False, **kwargs: Any) -> Any:
    twin = TWINS[name]
    return (twin.buffered if buffered else twin.make)(**kwargs)

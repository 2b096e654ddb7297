"""metrics_tpu_torch: the PyTorch/CUDA port of metrics_tpu.

A second package beside ``metrics_tpu`` (the JAX reference, left unchanged).
It imports torch and numpy and never JAX or ``metrics_tpu``. Metric state
lives on CUDA unless a metric is built with ``device="cpu"``; the TPU's
Pallas kernels become hand-written CUDA kernels under ``csrc/``, built with
``nvcc`` at first use. ``update()`` and ``compute()`` replay a captured CUDA
graph from the second call of each input signature (``core/engine.py``; the
switches below turn that off). ``observability`` traces, counts and serves
what the engines do and ``resilience`` injects seeded faults, retries and
guards state against NaN, as the JAX package's subpackages of those names
do; all are off by default. ``checkpoint`` saves and restores state in the
JAX package's on-disk format, ``tenancy`` stacks many tenants' states
behind one captured step a bucket, and ``serve`` feeds such a set from an
HTTP ingest queue (``cluster``, imported on its own, spreads tenants over
several of them).
"""
from metrics_tpu_torch.__about__ import __version__
from metrics_tpu_torch import functional
from metrics_tpu_torch.aggregation import (
    CatMetric,
    DistinctCount,
    HeavyHitters,
    MaxMetric,
    MeanMetric,
    Median,
    MinMetric,
    Quantile,
    SumMetric,
)
from metrics_tpu_torch import sketches
from metrics_tpu_torch import audio
from metrics_tpu_torch.audio import (
    PerceptualEvaluationSpeechQuality,
    PermutationInvariantTraining,
    ScaleInvariantSignalDistortionRatio,
    ScaleInvariantSignalNoiseRatio,
    ShortTimeObjectiveIntelligibility,
    SignalDistortionRatio,
    SignalNoiseRatio,
)
from metrics_tpu_torch.classification import (
    AUC,
    AUROC,
    Accuracy,
    AveragePrecision,
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    BinnedRecallAtFixedPrecision,
    CalibrationError,
    CohenKappa,
    ConfusionMatrix,
    CoverageError,
    Dice,
    F1Score,
    FBetaScore,
    HammingDistance,
    HingeLoss,
    JaccardIndex,
    KLDivergence,
    LabelRankingAveragePrecision,
    LabelRankingLoss,
    MatthewsCorrCoef,
    Precision,
    PrecisionRecallCurve,
    ROC,
    Recall,
    Specificity,
    StatScores,
)
from metrics_tpu_torch.core.buffers import CatBuffer
from metrics_tpu_torch.core.collections import MetricCollection
from metrics_tpu_torch.core.engine import (
    compiled_compute_enabled,
    compiled_update_enabled,
    fused_update_enabled,
    probation_cooldown,
    set_compiled_compute,
    set_compiled_update,
    set_fused_update,
    set_probation,
)
from metrics_tpu_torch.core.metric import CompositionalMetric, Metric
from metrics_tpu_torch.detection import MeanAveragePrecision
from metrics_tpu_torch import image, nets
from metrics_tpu_torch.image import (
    ErrorRelativeGlobalDimensionlessSynthesis,
    FrechetInceptionDistance,
    InceptionScore,
    KernelInceptionDistance,
    LearnedPerceptualImagePatchSimilarity,
    MultiScaleStructuralSimilarityIndexMeasure,
    PeakSignalNoiseRatio,
    SpectralAngleMapper,
    SpectralDistortionIndex,
    StructuralSimilarityIndexMeasure,
    UniversalImageQualityIndex,
)
from metrics_tpu_torch import observability  # noqa: F401
from metrics_tpu_torch import resilience  # noqa: F401
from metrics_tpu_torch import checkpoint  # noqa: F401
from metrics_tpu_torch.checkpoint import (  # noqa: F401
    restore_checkpoint,
    save_checkpoint,
    verify_checkpoint,
)
from metrics_tpu_torch import tenancy  # noqa: F401
from metrics_tpu_torch.tenancy import TenantSet  # noqa: F401
from metrics_tpu_torch import serve  # noqa: F401
from metrics_tpu_torch.parallel import (
    bucketed_sync_enabled,
    set_bucketed_sync,
    set_sync_cadence,
    set_sync_mode,
    set_sync_transport,
    sync_cadence_default,
    sync_mode_default,
    sync_transport_default,
    transport_error_bound,
)
from metrics_tpu_torch.regression import (
    CosineSimilarity,
    ExplainedVariance,
    MeanAbsoluteError,
    MeanAbsolutePercentageError,
    MeanSquaredError,
    MeanSquaredLogError,
    PearsonCorrCoef,
    R2Score,
    SpearmanCorrCoef,
    SymmetricMeanAbsolutePercentageError,
    TweedieDevianceScore,
    WeightedMeanAbsolutePercentageError,
)
from metrics_tpu_torch.retrieval import (
    RetrievalFallOut,
    RetrievalHitRate,
    RetrievalMAP,
    RetrievalMetric,
    RetrievalMRR,
    RetrievalNormalizedDCG,
    RetrievalPrecision,
    RetrievalPrecisionRecallCurve,
    RetrievalRecall,
    RetrievalRecallAtFixedPrecision,
    RetrievalRPrecision,
)
from metrics_tpu_torch.text import (
    BERTScore,
    BLEUScore,
    CharErrorRate,
    CHRFScore,
    ExtendedEditDistance,
    MatchErrorRate,
    ROUGEScore,
    SacreBLEUScore,
    SQuAD,
    TranslationEditRate,
    WordErrorRate,
    WordInfoLost,
    WordInfoPreserved,
)
from metrics_tpu_torch.wrappers import (
    BootStrapper,
    ClasswiseWrapper,
    MetricTracker,
    MinMaxMetric,
    MultioutputWrapper,
)

__all__ = [
    "__version__",
    "functional",
    "AUC",
    "AUROC",
    "Accuracy",
    "AveragePrecision",
    "BERTScore",
    "BinnedAveragePrecision",
    "BinnedPrecisionRecallCurve",
    "BinnedRecallAtFixedPrecision",
    "CalibrationError",
    "CatMetric",
    "CohenKappa",
    "CompositionalMetric",
    "ConfusionMatrix",
    "CosineSimilarity",
    "CoverageError",
    "Dice",
    "ExplainedVariance",
    "F1Score",
    "FBetaScore",
    "HammingDistance",
    "HingeLoss",
    "JaccardIndex",
    "KLDivergence",
    "LabelRankingAveragePrecision",
    "LabelRankingLoss",
    "MatthewsCorrCoef",
    "MaxMetric",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanAveragePrecision",
    "MeanMetric",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "Metric",
    "MetricCollection",
    "MinMetric",
    "PearsonCorrCoef",
    "Precision",
    "PrecisionRecallCurve",
    "R2Score",
    "ROC",
    "Recall",
    "RetrievalFallOut",
    "RetrievalHitRate",
    "RetrievalMAP",
    "RetrievalMRR",
    "RetrievalMetric",
    "RetrievalNormalizedDCG",
    "RetrievalPrecision",
    "RetrievalPrecisionRecallCurve",
    "RetrievalRPrecision",
    "RetrievalRecall",
    "RetrievalRecallAtFixedPrecision",
    "SpearmanCorrCoef",
    "Specificity",
    "StatScores",
    "SumMetric",
    "SymmetricMeanAbsolutePercentageError",
    "TweedieDevianceScore",
    "WeightedMeanAbsolutePercentageError",
    # sketch-backed aggregation (bounded-memory approximate metrics)
    "sketches", "Quantile", "Median", "DistinctCount", "HeavyHitters",
    # wrappers
    "BootStrapper", "ClasswiseWrapper", "MetricTracker", "MinMaxMetric", "MultioutputWrapper",
    # text
    "BLEUScore", "CHRFScore", "CharErrorRate", "ExtendedEditDistance", "MatchErrorRate", "ROUGEScore",
    "SQuAD", "SacreBLEUScore", "TranslationEditRate", "WordErrorRate", "WordInfoLost", "WordInfoPreserved",
    # audio
    "audio", "PerceptualEvaluationSpeechQuality", "PermutationInvariantTraining",
    "ScaleInvariantSignalDistortionRatio", "ScaleInvariantSignalNoiseRatio", "ShortTimeObjectiveIntelligibility",
    "SignalDistortionRatio", "SignalNoiseRatio",
    # image
    "image", "nets", "ErrorRelativeGlobalDimensionlessSynthesis", "FrechetInceptionDistance", "InceptionScore",
    "KernelInceptionDistance", "LearnedPerceptualImagePatchSimilarity", "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio", "SpectralAngleMapper", "SpectralDistortionIndex", "StructuralSimilarityIndexMeasure",
    "UniversalImageQualityIndex",
    # observability (event tracer, instrument registry, exporters, scrape server)
    "observability",
    # resilience (chaos harness, retry policies, non-finite guard)
    "resilience",
    # checkpoint
    "checkpoint", "save_checkpoint", "restore_checkpoint", "verify_checkpoint",
    # multi-tenant stacked state
    "tenancy", "TenantSet",
    "CatBuffer",
    "bucketed_sync_enabled",
    "compiled_compute_enabled",
    "compiled_update_enabled",
    "fused_update_enabled",
    "probation_cooldown",
    "set_bucketed_sync",
    "set_compiled_compute",
    "set_compiled_update",
    "set_fused_update",
    "set_probation",
    # sync transports, modes and cadence
    "set_sync_cadence", "set_sync_mode", "set_sync_transport", "sync_cadence_default", "sync_mode_default",
    "sync_transport_default", "transport_error_bound",
]

from metrics_tpu_torch.retrieval.base import RetrievalMetric  # noqa: F401
from metrics_tpu_torch.retrieval.metrics import (  # noqa: F401
    RetrievalFallOut,
    RetrievalHitRate,
    RetrievalMAP,
    RetrievalMRR,
    RetrievalNormalizedDCG,
    RetrievalPrecision,
    RetrievalRecall,
    RetrievalRPrecision,
)
from metrics_tpu_torch.retrieval.precision_recall_curve import (  # noqa: F401
    RetrievalPrecisionRecallCurve,
    RetrievalRecallAtFixedPrecision,
)

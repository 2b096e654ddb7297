from metrics_tpu_torch.regression.basic import (  # noqa: F401
    MeanAbsoluteError,
    MeanAbsolutePercentageError,
    MeanSquaredError,
    MeanSquaredLogError,
    SymmetricMeanAbsolutePercentageError,
    WeightedMeanAbsolutePercentageError,
)
from metrics_tpu_torch.regression.moments import (  # noqa: F401
    ExplainedVariance,
    PearsonCorrCoef,
    R2Score,
    SpearmanCorrCoef,
)
from metrics_tpu_torch.regression.other import CosineSimilarity, TweedieDevianceScore  # noqa: F401

"""Functional regression metrics on tensors (counterpart of
``metrics_tpu/ops/regression/__init__.py``)."""
from metrics_tpu_torch.ops.regression.basic import (  # noqa: F401
    mean_absolute_error,
    mean_absolute_percentage_error,
    mean_squared_error,
    mean_squared_log_error,
    symmetric_mean_absolute_percentage_error,
    weighted_mean_absolute_percentage_error,
)
from metrics_tpu_torch.ops.regression.moments import (  # noqa: F401
    explained_variance,
    pearson_corrcoef,
    r2_score,
    spearman_corrcoef,
)
from metrics_tpu_torch.ops.regression.other import cosine_similarity, tweedie_deviance_score  # noqa: F401

"""Utility layer (counterpart of ``metrics_tpu/utils/__init__.py``)."""
from metrics_tpu_torch.utils.checks import _check_same_shape, check_forward_full_state_property  # noqa: F401
from metrics_tpu_torch.utils.data import (  # noqa: F401
    METRIC_EPS,
    allclose,
    apply_to_collection,
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
    get_group_indexes,
    select_topk,
    to_categorical,
    to_onehot,
)
from metrics_tpu_torch.utils.exceptions import MetricsUserError, MetricsUserWarning  # noqa: F401
from metrics_tpu_torch.utils.prints import rank_zero_debug, rank_zero_info, rank_zero_warn  # noqa: F401

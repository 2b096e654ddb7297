"""Core metric runtime (counterpart of ``metrics_tpu/core/__init__.py``)."""
from metrics_tpu_torch.core.buffers import CatBuffer  # noqa: F401
from metrics_tpu_torch.core.collections import MetricCollection  # noqa: F401
from metrics_tpu_torch.core.engine import (  # noqa: F401
    CollectionComputeEngine,
    CollectionDispatcher,
    CollectionPartition,
    CollectionUpdateEngine,
    CompiledComputeEngine,
    CompiledUpdateEngine,
    EngineStats,
    PartitionStats,
    classify_compute_member,
    classify_update_member,
    compiled_compute_enabled,
    compiled_update_enabled,
    fused_update_enabled,
    probation_cooldown,
    set_compiled_compute,
    set_compiled_update,
    set_fused_update,
    set_probation,
)
from metrics_tpu_torch.core.metric import CompositionalMetric, Metric  # noqa: F401

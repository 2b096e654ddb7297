"""metrics_tpu_torch.autotune: self-tuning sync under the error-budget gate.

Counterpart of ``metrics_tpu.autotune``. An opt-in controller picks the sync
transport (exact, bf16, int8, sparse_count) and the incremental cadence K
per (reduction, dtype) bucket from the observed history, with the
error-budget gate as the hard safety floor: the tuner only ever chooses
what the gate admits, and never loosens it.

Quick start::

    import metrics_tpu_torch

    metrics_tpu_torch.set_autotune(True)          # live explore-then-commit
    ... run the workload; the engines rebuild when decision_epoch() moves ...
    plan = metrics_tpu_torch.export_tuned_plan()  # pin for reproducibility
    plan.save("tuned_plan.json")

    metrics_tpu_torch.set_autotune(plan)          # replay: zero exploration
    # or: METRICS_TPU_AUTOTUNE=/path/to/tuned_plan.json

A plan saved by either package pins the other.
"""
from metrics_tpu_torch.autotune.controller import (
    AutotuneController,
    CADENCE_LADDER,
    LADDER,
    PolicyConfig,
    autotune_enabled,
    decision_epoch,
    export_plan,
    get_controller,
    partition_token,
    set_autotune,
)
from metrics_tpu_torch.autotune.history import BucketHistory, BucketSample
from metrics_tpu_torch.autotune.plan import TunedPlan, bucket_key, plan_drift

__all__ = [
    "AutotuneController",
    "BucketHistory",
    "BucketSample",
    "CADENCE_LADDER",
    "LADDER",
    "PolicyConfig",
    "TunedPlan",
    "autotune_enabled",
    "bucket_key",
    "decision_epoch",
    "export_plan",
    "get_controller",
    "partition_token",
    "plan_drift",
    "set_autotune",
]

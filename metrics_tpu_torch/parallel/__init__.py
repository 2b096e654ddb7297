"""Metric state sync across processes (counterpart of ``metrics_tpu/parallel``)."""
from metrics_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from metrics_tpu_torch.parallel.sync import (  # noqa: F401
    bucketed_sync_enabled,
    count_collectives,
    current_sync_axes,
    distributed_available,
    gather_all_arrays,
    set_bucketed_sync,
    sync_array,
    sync_axes,
    sync_state,
)

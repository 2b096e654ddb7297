"""metrics_tpu_torch.serve — the online ingestion front-end.

Counterpart of ``metrics_tpu/serve/``, host code around the port's
:class:`~metrics_tpu_torch.tenancy.TenantSet`.

ingest → batch → dispatch → serve: per-tenant observation batches arrive
over HTTP (or in-process), a bounded queue applies admission control and
backpressure, a coalescer folds ragged arrivals into distinct-tenant device
batches, one dispatcher thread drives them through a
:class:`~metrics_tpu_torch.tenancy.TenantSet` (pow2-bucketed, one captured
step a bucket width), and reads serve each tenant's ``compute()`` with an explicit
staleness bound.
"""
from metrics_tpu_torch.serve.client import IngestClient, offline_replay
from metrics_tpu_torch.serve.coalesce import (
    Admission,
    BoundedIngestQueue,
    Observation,
)
from metrics_tpu_torch.serve.dispatcher import DeadLetter, Dispatcher, DispatchStats
from metrics_tpu_torch.serve.server import (
    DeadlineMissed,
    IngestPipeline,
    IngestServer,
    UnknownTenant,
    decode_body,
    decode_steps,
    encode_npz,
    encode_npz_steps,
    get_server,
    serve,
    shutdown,
)

__all__ = [
    "Admission",
    "BoundedIngestQueue",
    "DeadLetter",
    "DeadlineMissed",
    "Dispatcher",
    "DispatchStats",
    "IngestClient",
    "IngestPipeline",
    "IngestServer",
    "Observation",
    "UnknownTenant",
    "decode_body",
    "decode_steps",
    "encode_npz",
    "encode_npz_steps",
    "get_server",
    "offline_replay",
    "serve",
    "shutdown",
]

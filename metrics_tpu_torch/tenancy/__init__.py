"""metrics_tpu_torch.tenancy — multi-tenant streaming metrics.

Counterpart of ``metrics_tpu/tenancy``. One process serving thousands of
concurrent streams should not pay one captured step, or one Python dispatch
loop, per stream. A :class:`TenantSet` stacks N structurally identical
:class:`~metrics_tpu_torch.MetricCollection` states on a leading axis and
routes ``update``/``compute`` through one vmapped step a pow2 bucket of
tenants, captured once per bucket width on the card; per-tenant reset,
evict and admit never capture anything new once their width is warm.
"""
from metrics_tpu_torch.tenancy.tenant_set import TenantSet, TenantStats  # noqa: F401

__all__ = ["TenantSet", "TenantStats"]

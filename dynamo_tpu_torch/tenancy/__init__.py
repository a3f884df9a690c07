"""Multi-tenant serving plane (a copy of the JAX package's tenancy/):
resident LoRA adapter multiplexing, per-tenant quota/fairness, and
tenant-sliced observability.

  adapters.py  resident LoRA banks + the variant-name registry
  quotas.py    per-tenant admission budgets, SFQ fair-share stamps,
               tenant-derived Retry-After
  metrics.py   the ``dynamo_tenant_*`` labelled metric families
"""
from dynamo_tpu_torch.tenancy.metrics import TENANT, TenantRegistry
from dynamo_tpu_torch.tenancy.quotas import (
    DEFAULT_TENANT,
    TENANT_HEADER,
    TenantQuotas,
    parse_tenant,
)

__all__ = [
    "TENANT",
    "TenantRegistry",
    "TENANT_HEADER",
    "DEFAULT_TENANT",
    "TenantQuotas",
    "parse_tenant",
]

"""Tenant identity minted at the frontend (a copy of the JAX package's
tenancy/quotas.py, cut to ``parse_tenant``; per-tenant budgets are not
ported yet).

A request names its tenant with the ``X-Tenant-Id`` header or the
``nvext.tenant`` body field; legacy traffic falls into the ``default``
tenant. The engine orders same-priority waiting requests by per-tenant
start-time fair queuing.
"""
from __future__ import annotations

from typing import Any

TENANT_HEADER = "X-Tenant-Id"
DEFAULT_TENANT = "default"


def parse_tenant(value: Any) -> str:
    """Header/body tenant value -> a label-safe tenant id. Malformed or
    empty values fall into the default tenant — a bad hint must not
    fail the request."""
    if value is None:
        return DEFAULT_TENANT
    t = "".join(
        ch for ch in str(value).strip() if ch not in '"\\\n\r'
    )
    return t[:64] or DEFAULT_TENANT
